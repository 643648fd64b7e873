"""DSR-Splines, learned per-colour-range transfer functions (port of
srcaco2_tpu/models/dsr_splines.py): the colour range [color_min,
color_max] is split into n_splines_per_color contiguous knot intervals;
each interval owns a small spline network (an in_ksz conv and a 1x1
stack, optional local residuals, a tanh head under the global residual)
whose output counts only at the pixels whose uint8 level falls inside
its knots. The spline outputs sum, optionally added to the bicubic
upscale (global residual). Exposes x_interp / global_residual.

JAX runs the S spline branches as one nn.vmap-ped bank (every param with
a leading S axis: `splines/Conv_0/kernel` is (S, k, k, I, O)). The port
runs them as one batched network: the first layer a conv from in_planes
to S * h0 channels (every branch sees the same input), the 1x1 layers
and their local-residual projections grouped convs with groups=S, the
head S * in_planes channels; branch s owns channels [s * c, (s + 1) * c)
of each layer (bridge.flax_to_torch lays the bank out so). The knot
masks are computed as JAX computes them, in f32 from the f32 bicubic
upscale, with no gradient; exactly one is 1 at each pixel, so the masked
sum over the branches is exact in any order."""
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.models.blocks import (FlaxNamed, bicubic_up,
                                             raw_conv, reset_all)


def make_knots(color_min: int, color_max: int, n_splines: int
               ) -> List[Tuple[int, int]]:
    colors = list(range(color_min, color_max)) + [color_max]
    splits = np.array_split(colors, n_splines)
    return [(int(min(s)), int(max(s))) for s in splits]


class SplineBank(FlaxNamed):
    """The S spline networks as one: `layer` of the JAX _SplineNet for
    every branch at once. Conv_<n> follow flax's names inside one
    branch (each layer's conv, then its residual projection where the
    width changes)."""

    def __init__(self, n_splines, in_planes, h_layers, in_ksz,
                 use_local_residual, use_global_residual, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        s = n_splines
        self.n_splines, self.local = s, use_local_residual
        self.out_act = torch.tanh if use_global_residual else F.relu
        widths = list(h_layers) + [in_planes]
        self.layers = []
        c_in, shared = in_planes, True      # layer 0 reads the shared input
        for i, out_c in enumerate(widths):
            k = in_ksz if i == 0 else 1
            g = 1 if shared else s
            conv = self.child('Conv', raw_conv(
                c_in * (1 if shared else s), s * out_c, k, groups=g,
                pad_mode='reflect', **kw))
            proj = None
            if use_local_residual and c_in != out_c:
                proj = self.child('Conv', raw_conv(
                    c_in * (1 if shared else s), s * out_c, 1, groups=g,
                    **kw))
            self.layers.append((conv, proj, shared))
            c_in, shared = out_c, False

    def forward(self, x):
        h = x
        last = len(self.layers) - 1
        for i, (conv, proj, shared) in enumerate(self.layers):
            y = conv(h)
            if self.local:
                y = F.relu(y)
                if proj is not None:
                    z = proj(h)
                else:
                    z = h.repeat(1, self.n_splines, 1, 1) if shared else h
                y = y + z
            h = self.out_act(y) if i == last else F.relu(y)
        return h


class DSRSplines(nn.Module):
    def __init__(self, in_planes: int = 1, upscale: int = 2, in_ksz: int = 3,
                 splinenet_type: str = 'snet_type1',
                 n_splines_per_color: int = 16, color_min: int = 0,
                 color_max: int = 255, use_local_residual: bool = False,
                 use_global_residual: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        assert in_planes == 1, \
            'multi-plane splines grow as n^planes; reference tested grey'
        self.upscale, self.dtype = upscale, dtype
        self.color_min, self.color_max = color_min, color_max
        self.use_global_residual = use_global_residual
        self.knots = make_knots(color_min, color_max, n_splines_per_color)
        self.splines = SplineBank(
            len(self.knots), in_planes,
            tuple(constants.SPLINEHIDDEN[splinenet_type]), in_ksz,
            use_local_residual, use_global_residual, dtype=dtype,
            device=device)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    @torch.no_grad()
    def masks(self, y: torch.Tensor) -> torch.Tensor:
        """(B, S, H, W) knot masks of the f32 (B, 1, H, W) upscale: 1
        where clip(floor(y * color_max)) lies in knot s's closed
        interval."""
        x_un = torch.clip(torch.floor(y * self.color_max), self.color_min,
                          self.color_max)
        lows, highs = (torch.tensor(k, dtype=y.dtype, device=y.device)
                       [None, :, None, None] for k in zip(*self.knots))
        return ((x_un >= lows) & (x_un <= highs)).to(y.dtype)

    def forward(self, x):
        x_up = bicubic_up(x, self.upscale)
        mask = self.masks(x_up)
        preds = self.splines(x_up)
        b, _, h, w = preds.shape
        s = len(self.knots)
        # compute dtype * f32 mask promotes to f32, as in JAX
        out = (preds.reshape(b, s, -1, h, w) * mask[:, :, None]).sum(1)
        res = {'out': out, 'x_interp': x_up}
        if self.use_global_residual:
            res['global_residual'] = out
            res['out'] = out + x_up
        return res
