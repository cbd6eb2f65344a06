"""Models: the per-bin LDA decision functions."""
