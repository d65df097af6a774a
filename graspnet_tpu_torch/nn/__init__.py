"""Eval-mode layers: Dense, BatchNorm, SharedMLP and BN folding."""
