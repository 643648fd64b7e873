"""Kernels written by hand for Hopper and their plain PyTorch versions."""
