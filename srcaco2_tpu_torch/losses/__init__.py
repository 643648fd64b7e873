"""Losses of the training step (the l1, l2 and neg-SSIM terms so far)."""
