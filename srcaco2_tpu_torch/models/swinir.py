"""SwinIR for super-resolution (port of srcaco2_tpu/models/swinir.py).

Same network as the JAX module with `fused_blocks=True`: mean /
img_range, reflect pad to the window size, conv_first, patch-norm LN,
residual Swin stages (RSTB: a FusedBlockStack + 1conv or 3conv
residual), final LN, conv_after_body and the three upsamplers. Swin
blocks work in NHWC, convolutions in NCHW. Parameters are f32; `dtype`
is the compute dtype (bf16 under amp). The module's training flag
(`model.train()` / `model.eval()`) is the JAX module's `train`
argument: it keeps the forward-only tiled path of the Swin stages
(`fused_tiled=not train`) out of training.

State-dict names (the bridge maps the flax tree onto them):
conv_first, patch_norm, stages.{s}.blocks.<leaf>, stages.{s}.convs.{i},
norm, conv_after_body, and conv_before_up / upsample.convs.{i} /
conv_last (pixelshuffle), upsample.conv (pixelshuffledirect) or
nearest.{i} (nearest_conv).
"""
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.models.blocks import Conv, Upsampler, UpsamplerDirect
from srcaco2_tpu_torch.ops.swin_block import LN_EPS


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) gather index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive (nW, ws^2, ws^2) mask (0 / -100) for shifted windows."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: statistics in f32, output in dtype
    (flax nn.LayerNorm(epsilon=1e-5, dtype=dtype))."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, gen: torch.Generator):
        del gen
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS).to(self.dtype)


class RSTB(nn.Module):
    """Residual Swin Transformer Block over NHWC: depth blocks, then a
    1conv or 3conv (bottleneck) convolution, plus the residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float,
                 resi_connection: str = constants.R_CONNECTION_1CONV, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
        self.blocks = FusedBlockStack(dim, depth, num_heads, window_size,
                                      mlp_ratio, dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        if resi_connection == constants.R_CONNECTION_1CONV:
            convs = [Conv(dim, dim, 3, **kw)]
        elif resi_connection == constants.R_CONNECTION_3CONV:
            convs = [Conv(dim, dim // 4, 3, **kw),
                     Conv(dim // 4, dim // 4, 1, **kw),
                     Conv(dim // 4, dim, 3, **kw)]
        else:
            raise NotImplementedError(resi_connection)
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        y = self.blocks(x).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            y = conv(y)
            if i < len(self.convs) - 1:
                y = F.leaky_relu(y, 0.2)
        return y.permute(0, 2, 3, 1) + x


class SwinIR(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 img_range: float = 1.0, window_size: int = 8,
                 embed_dim: int = 180, depths=(6, 6, 6, 6, 6, 6),
                 num_heads=(6, 6, 6, 6, 6, 6), mlp_ratio: float = 2.0,
                 upsampler: str = constants.US_PIXEL_SHUFFLE,
                 resi_connection: str = constants.R_CONNECTION_1CONV, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_chans, self.upscale = in_chans, upscale
        self.img_range, self.window_size = img_range, window_size
        self.upsampler, self.dtype = upsampler, dtype
        kw = dict(dtype=dtype, device=device)
        if in_chans == 3:
            mean = torch.tensor([0.4488, 0.4371, 0.4040]).reshape(1, 3, 1, 1)
        else:
            mean = torch.zeros(1, 1, 1, 1)
        self.register_buffer('mean', mean.to(device), persistent=False)
        self.conv_first = Conv(in_chans, embed_dim, 3, **kw)
        self.patch_norm = LayerNorm(embed_dim, **kw)
        self.stages = nn.ModuleList(
            RSTB(embed_dim, d, nh, window_size, mlp_ratio, resi_connection,
                 **kw) for d, nh in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim, **kw)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, **kw)
        if upsampler == constants.US_PIXEL_SHUFFLE:
            self.conv_before_up = Conv(embed_dim, 64, 3, **kw)
            self.upsample = Upsampler(upscale, 64, **kw)
            self.conv_last = Conv(64, in_chans, 3, **kw)
        elif upsampler == constants.US_PIXEL_SHUFFLE_DIRECT:
            self.upsample = UpsamplerDirect(upscale, embed_dim, in_chans,
                                            **kw)
        elif upsampler == constants.US_NEAREST_CONV:
            n_up = int(math.log2(upscale))
            self.nearest = nn.ModuleList(
                [Conv(embed_dim, 64, 3, **kw)]
                + [Conv(64, 64, 3, **kw) for _ in range(n_up + 1)]
                + [Conv(64, in_chans, 3, **kw)])
        else:
            raise NotImplementedError(upsampler)

    def reset_parameters(self, gen: torch.Generator):
        """Seeded init of every submodule, in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, 'reset_parameters'):
                m.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) in [0, 1] -> (B, C, H*up, W*up) f32."""
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        h0, w0 = x.shape[-2:]
        ws = self.window_size
        ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode='reflect')
        feat = self.conv_first(x)
        body = self.patch_norm(feat.permute(0, 2, 3, 1))
        for stage in self.stages:
            body = stage(body)
        body = self.norm(body)
        feat = feat + self.conv_after_body(body.permute(0, 3, 1, 2))

        if self.upsampler == constants.US_PIXEL_SHUFFLE:
            u = F.leaky_relu(self.conv_before_up(feat), 0.01)
            out = self.conv_last(self.upsample(u))
        elif self.upsampler == constants.US_PIXEL_SHUFFLE_DIRECT:
            out = self.upsample(feat)
        else:
            convs = self.nearest
            u = F.leaky_relu(convs[0](feat), 0.01)
            for conv in convs[1:-2]:
                u = F.interpolate(u, scale_factor=2, mode='nearest')
                u = F.leaky_relu(conv(u), 0.2)
            u = F.leaky_relu(convs[-2](u), 0.2)
            out = convs[-1](u)
        out = out[..., :h0 * self.upscale, :w0 * self.upscale]
        return (out / self.img_range).float() + mean
