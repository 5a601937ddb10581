"""Training: the counterpart of ``repro.train`` (optimizer, int8 optimizer
state, synthetic data, checkpoints, the train step)."""
