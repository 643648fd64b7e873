"""Shared model building blocks (port of srcaco2_tpu/models/blocks.py).

The JAX package computes convolutions in NHWC; the port keeps PyTorch's
NCHW for them (cuDNN's layout) and holds parameters in PyTorch's
layouts: conv weights (O, I, kh, kw). Parameters are f32; `dtype` is
the compute dtype that inputs and weights are cast to, as flax does.
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Module):
    """Square conv, stride 1, with torch-like 'SAME' padding
    (k - 1) // 2 on every side. NCHW in and out, in `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.pad = (kernel - 1) // 2
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def reset_parameters(self, gen: torch.Generator):
        """flax's variance_scaling(1, fan_in, uniform) kernel (torch's
        Conv2d default family) and zero bias."""
        fan_in = self.weight[0].numel()
        bound = math.sqrt(3.0 / fan_in)
        _uniform_(self.weight, -bound, bound, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        # flax's two rounding points: the convolution rounds to the
        # compute dtype, then the bias is added in that dtype
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                     padding=self.pad)
        return y + self.bias.to(self.dtype)[:, None, None]


def _uniform_(p: torch.Tensor, lo: float, hi: float,
              gen: torch.Generator):
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=gen) * (hi - lo) + lo)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NCHW: (B, C*r^2, H, W) -> (B, C, H*r, W*r) with
    input channel c*r^2 + dy*r + dx going to output channel c at offset
    (dy, dx), the order of srcaco2_tpu/models/blocks.py:pixel_shuffle
    (and of torch.nn.PixelShuffle)."""
    b, c, h, w = x.shape
    r = factor
    oc = c // (r * r)
    x = x.reshape(b, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, oc, h * r, w * r)


class Upsampler(nn.Module):
    """Pixel-shuffle upsampler: xN in factor-of-2 steps (or one x3)."""

    def __init__(self, scale: int, features: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if scale & (scale - 1) == 0:
            steps, mult, self.factor = scale.bit_length() - 1, 4, 2
        elif scale == 3:
            steps, mult, self.factor = 1, 9, 3
        else:
            raise NotImplementedError(scale)
        self.convs = nn.ModuleList(
            Conv(features, mult * features, 3, dtype=dtype, device=device)
            for _ in range(steps))

    def forward(self, x):
        for conv in self.convs:
            x = pixel_shuffle(conv(x), self.factor)
        return x


class UpsamplerDirect(nn.Module):
    """One conv straight to out_chans * scale^2, then pixel shuffle
    (SwinIR's 'pixelshuffledirect')."""

    def __init__(self, scale: int, in_ch: int, out_chans: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scale = scale
        self.conv = Conv(in_ch, out_chans * scale ** 2, 3, dtype=dtype,
                         device=device)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.scale)
