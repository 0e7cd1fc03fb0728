"""Config, losses, optimizers, metrics and the trainer."""
