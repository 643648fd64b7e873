"""Image transforms (port of srcaco2_tpu/data/pipeline.py:dihedral)."""
import torch


def dihedral(img: torch.Tensor, mode: int) -> torch.Tensor:
    """One of the 8 dihedral transforms of an (..., H, W, C) image, in
    the JAX order: modes 0-3 rotate by mode * 90 degrees (from the H axis
    towards the W axis), modes 4-7 rotate by (mode - 4) * 90 degrees and
    then flip H."""
    out = torch.rot90(img, k=mode % 4, dims=(-3, -2))
    return torch.flip(out, dims=(-3,)) if mode >= 4 else out


def reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the n + 2 pad positions of an axis of
    size n reflected by `pad` at both ends without repeating the edge
    (numpy's and jnp.pad's mode='reflect'), for any pad: past the first
    reflection the pattern repeats with period 2(n - 1), as numpy's
    does, where torch's reflect padding refuses pad >= n."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    if n == 1:
        return torch.zeros_like(i)
    i = i % (2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x (..., H, W) reflected by `pad` on both sides of its last two
    axes (reflect_index)."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, reflect_index(h, pad, x.device))
    return x.index_select(-1, reflect_index(w, pad, x.device))
