"""The port's launch entry points: the training script."""
