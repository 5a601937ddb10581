"""Step accounting and roofline analysis for the port."""
