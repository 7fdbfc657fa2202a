"""Training: the trainer, its optimizer, checkpoints and metric logging."""
