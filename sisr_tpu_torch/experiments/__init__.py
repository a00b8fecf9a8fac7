"""Config-driven experiments: train, evaluate, test and resume."""
