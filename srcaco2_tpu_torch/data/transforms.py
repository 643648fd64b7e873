"""Image transforms (port of srcaco2_tpu/data/pipeline.py:dihedral)."""
import torch


def dihedral(img: torch.Tensor, mode: int) -> torch.Tensor:
    """One of the 8 dihedral transforms of an (..., H, W, C) image, in
    the JAX order: modes 0-3 rotate by mode * 90 degrees (from the H axis
    towards the W axis), modes 4-7 rotate by (mode - 4) * 90 degrees and
    then flip H."""
    out = torch.rot90(img, k=mode % 4, dims=(-3, -2))
    return torch.flip(out, dims=(-3,)) if mode >= 4 else out
