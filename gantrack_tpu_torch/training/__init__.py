"""Training: augmentation, losses, the step, the loop."""
