"""Training: losses, the train and eval steps, checkpoints."""
