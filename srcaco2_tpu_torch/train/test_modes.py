"""Tiled / ensembled inference modes (port of
srcaco2_tpu/train/test_modes.py): 0 normal, 1 pad-to-modulo, 2 recursive
spatial split, 3 x8 geometric self-ensemble, 4 split + x8."""
import math
from typing import Callable

import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.data.transforms import dihedral


def test_pad(fwd: Callable, l_im: torch.Tensor, modulo: int = 16,
             sf: int = 1) -> torch.Tensor:
    h, w = l_im.shape[-2:]
    pb = int(math.ceil(h / modulo) * modulo - h)
    pr = int(math.ceil(w / modulo) * modulo - w)
    if pb or pr:
        l_im = F.pad(l_im, (0, pr, 0, pb), mode='replicate')
    return fwd(l_im)[..., :h * sf, :w * sf]


def test_split(fwd: Callable, l_im: torch.Tensor, refield: int = 32,
               min_size: int = 256, sf: int = 1,
               modulo: int = 1) -> torch.Tensor:
    """Recursive quadrant split (overlapping tiles, seam-free paste)."""
    h, w = l_im.shape[-2:]
    if h * w <= min_size ** 2:
        return test_pad(fwd, l_im, modulo, sf)
    top = (h // 2 // refield + 1) * refield
    left = (w // 2 // refield + 1) * refield
    ls = [l_im[..., :top, :left], l_im[..., :top, w - left:],
          l_im[..., h - top:, :left], l_im[..., h - top:, w - left:]]
    if h * w <= 4 * min_size ** 2:
        es = [fwd(t) for t in ls]
    else:
        es = [test_split(fwd, t, refield, min_size, sf, modulo)
              for t in ls]
    b, c = es[0].shape[:2]
    h2, w2 = h // 2, w // 2
    out = torch.zeros((b, c, sf * h, sf * w), dtype=es[0].dtype,
                      device=es[0].device)
    out[..., :h2 * sf, :w2 * sf] = es[0][..., :h2 * sf, :w2 * sf]
    out[..., :h2 * sf, w2 * sf:] = es[1][..., :h2 * sf, (w2 - w) * sf:]
    out[..., h2 * sf:, :w2 * sf] = es[2][..., (h2 - h) * sf:, :w2 * sf]
    out[..., h2 * sf:, w2 * sf:] = es[3][..., (h2 - h) * sf:,
                                         (w2 - w) * sf:]
    return out


def test_x8(fwd: Callable, l_im: torch.Tensor, modulo: int = 1,
            sf: int = 1) -> torch.Tensor:
    """Geometric self-ensemble: the mean of the 8 dihedral variants, in
    one batched forward when the input is square."""
    b = l_im.shape[0]
    hwc = l_im.permute(0, 2, 3, 1)
    variants = [dihedral(hwc, m) for m in range(8)]
    if l_im.shape[-2] == l_im.shape[-1]:
        batch = torch.cat(variants).permute(0, 3, 1, 2)
        e = test_pad(fwd, batch, modulo, sf)
        es = [e[m * b:(m + 1) * b].permute(0, 2, 3, 1) for m in range(8)]
    else:
        es = [test_pad(fwd, v.permute(0, 3, 1, 2), modulo,
                       sf).permute(0, 2, 3, 1) for v in variants]
    # rot(k)^-1 = rot(4-k); the flip variants are involutions
    inverse = [0, 3, 2, 1, 4, 5, 6, 7]
    outs = [dihedral(es[m], inverse[m]).permute(0, 3, 1, 2)
            for m in range(8)]
    return sum(outs) / 8.0


def test_mode(fwd: Callable, l_im: torch.Tensor, mode: int = 0,
              refield: int = 32, min_size: int = 256, sf: int = 1,
              modulo: int = 1) -> torch.Tensor:
    if mode == 0:
        return fwd(l_im)
    if mode == 1:
        return test_pad(fwd, l_im, modulo, sf)
    if mode == 2:
        return test_split(fwd, l_im, refield, min_size, sf, modulo)
    if mode == 3:
        return test_x8(fwd, l_im, modulo, sf)
    if mode == 4:
        def x8fwd(t):
            return test_x8(fwd, t, modulo, sf)
        return test_split(x8fwd, l_im, refield, min_size, sf, modulo)
    raise NotImplementedError(mode)
