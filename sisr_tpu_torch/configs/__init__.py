"""Experiment and model configuration with the optimizer, loss and
learning-rate schedule factories."""
