"""Training: targets, losses, the AdamW trainer, the loop and checkpoints."""
