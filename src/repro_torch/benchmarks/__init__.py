"""Real-timing benchmark suites of the port."""
