"""Training: the label pipeline (host numpy half, device torch half), the
loss, and the single-card Trainer."""
