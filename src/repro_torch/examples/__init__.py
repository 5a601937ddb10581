"""The port's examples: ``python -m repro_torch.examples.<name>``."""
