"""SwinIR for super-resolution (port of srcaco2_tpu/models/swinir.py).

The network of the JAX module: mean / img_range, reflect pad to the
window size, conv_first, patch-norm LN, residual Swin stages (RSTB: the
Swin blocks + 1conv or 3conv residual), final LN, conv_after_body and
the three upsamplers. Swin blocks work in NHWC, convolutions in NCHW.
Parameters are f32; `dtype` is the compute dtype (bf16 under amp). The
module's training flag (`model.train()` / `model.eval()`) is the JAX
module's `train` argument: it keeps the forward-only tiled path of the
fused stages (`fused_tiled=not train`) out of training.

Two block layouts, as in JAX:
  * `fused_blocks=True` (the port's default, what define_g builds for
    `swinir_use_fused_blocks`): each stage is a FusedBlockStack over
    stacked parameters (models/swin_fused.py);
  * `fused_blocks=False` (JAX's default): each stage is a list of
    SwinBlocks (LN, roll, window partition, WindowAttention, reverse,
    roll back, residual, LN, tanh-GELU MLP, residual), shifts 0 and
    ws/2 alternating. `use_pallas_attn` selects the attention core of
    WindowAttention: ops/window_attention.window_attention (K6 on the
    card, forward-only: the eval path) or the plain formulation of
    JAX's XLA branch, a different function in bf16.

State-dict names (the bridge maps the flax tree onto them):
conv_first, patch_norm, stages.{s}.blocks.<leaf> (fused) or
stages.{s}.blocks.{i}.{norm1, attn.qkv, attn.proj, attn.rel_pos_bias,
norm2, fc1, fc2} (unfused; dense weights in the flax (in, out) layout),
stages.{s}.convs.{i}, norm, conv_after_body, and conv_before_up /
upsample.convs.{i} / conv_last (pixelshuffle), upsample.conv
(pixelshuffledirect) or nearest.{i} (nearest_conv).
"""
import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.models import blocks
from srcaco2_tpu_torch.models.blocks import Conv, Upsampler, UpsamplerDirect
from srcaco2_tpu_torch.ops.swin_block import LN_EPS, _const
from srcaco2_tpu_torch.ops.window_attention import window_attention


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
    (flax nn.LayerNorm(epsilon=eps, dtype=dtype); SwinIR's eps is 1e-5,
    flax's default 1e-6)."""

    def __init__(self, dim: int, *, eps: float = LN_EPS,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, gen: torch.Generator):
        del gen
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(blocks.stat_dtype(x.dtype))
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps).to(self.dtype)


def _trunc_normal_(p: torch.Tensor, std: float, gen: torch.Generator):
    """Truncated normal in [-2 std, 2 std], drawn on the CPU from gen."""
    with torch.no_grad():
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        p.copy_(t)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two operands in their (compute) dtype with f32
    accumulation and one rounding, as a dot_general in that dtype."""
    return torch.matmul(a, b)


def _swin_dense_init(p, gen, fan_in, fan_out):
    """Truncated-normal dense kernel, std 1/sqrt(fan_in), cut at 2 std (as
    FusedBlockStack draws its dense kernels)."""
    del fan_out
    _trunc_normal_(p, 1.0 / math.sqrt(fan_in), gen)


def Dense(in_features: int, out_features: int, *, dtype=torch.float32,
          device=None) -> blocks.Dense:
    """flax nn.Dense(dtype=dtype) with SwinIR's kernel init; the weight
    keeps the flax (in, out) layout: y = x @ weight + bias."""
    return blocks.Dense(in_features, out_features, init=_swin_dense_init,
                        dtype=dtype, device=device)


def _flax_gelu(u: torch.Tensor, tanh=torch.tanh) -> torch.Tensor:
    """jax.nn.gelu(approximate=True) (flax nn.gelu) in u's dtype, one
    rounding per op: x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))),
    with x^3 = x * (x * x) as lax.integer_pow expands it and the
    constants rounded to u's dtype."""
    c = _const(math.sqrt(2 / math.pi), u.dtype)
    cube = u * (u * u)
    inner = u + _const(0.044715, u.dtype) * cube
    return u * (0.5 * (1.0 + tanh(c * inner)))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis in x's dtype: exp(x - max)
    rounded to the dtype, its sum in f32 (jnp.sum upcasts; blocks.stat_dtype)
    rounded to the dtype, then the division."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.to(blocks.stat_dtype(e.dtype)).sum(-1, keepdim=True).to(
        x.dtype)


@functools.lru_cache(maxsize=None)
def _rel_index_on(ws: int, device: str) -> torch.Tensor:
    """The flat relative position index on `device`, a normal tensor even
    when first built under inference_mode (training reuses it)."""
    with torch.inference_mode(False):
        return torch.as_tensor(relative_position_index(ws).reshape(-1),
                               dtype=torch.long).to(device)


@functools.lru_cache(maxsize=64)
def _shift_mask_on(h: int, w: int, ws: int, shift: int,
                   device: str) -> torch.Tensor:
    """shift_attn_mask as an f32 tensor on `device`, copied there once."""
    return torch.as_tensor(shift_attn_mask(h, w, ws, shift)).to(device)


class WindowAttention(nn.Module):
    """W-MSA with a learned relative position bias over (B*nW, N, C)
    windows (JAX WindowAttention). `use_pallas` routes the core through
    ops/window_attention.window_attention, the function of the TPU kernel:
    the f32 bias table rounded to the compute dtype, then everything in
    f32 with one rounding of the output. Otherwise the core is JAX's XLA
    branch, every op in the compute dtype."""

    def __init__(self, dim: int, window_size: int, num_heads: int, *,
                 dtype=torch.float32, use_pallas: bool = False,
                 device=None):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.dtype, self.use_pallas = dtype, use_pallas
        self.rel_pos_bias = nn.Parameter(torch.zeros(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        # the core of the use_pallas branch; a measurement can swap in
        # ops/window_attention.window_attention_ref to compare paths
        self.attn_op = window_attention

    def reset_parameters(self, gen: torch.Generator):
        _trunc_normal_(self.rel_pos_bias, 0.02, gen)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x: (B*nW, N, C); mask: (nW, N, N) f32 additive or None."""
        bnw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        idx = _rel_index_on(self.window_size, str(x.device))
        bias = self.rel_pos_bias[idx].reshape(n, n, nh).permute(2, 0, 1)
        qkv = self.qkv(x)
        if self.use_pallas:
            # contiguous in the one cast: K6 reads the bias as it lies
            out = self.attn_op(qkv, bias.to(
                qkv.dtype, memory_format=torch.contiguous_format), mask,
                heads=nh)
            return self.proj(out)
        q, k, v = qkv.reshape(bnw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = _mm(q * _const(hd ** -0.5, q.dtype), k.transpose(-1, -2))
        attn = attn + bias.to(attn.dtype)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, nh, n, n)
                    + mask.to(attn.dtype)[None, :, None]
                    ).reshape(bnw, nh, n, n)
        out = _mm(_softmax(attn), v)
        return self.proj(out.permute(0, 2, 1, 3).reshape(bnw, n, c))


class SwinBlock(nn.Module):
    """One Swin block over (B, H, W, C), H and W multiples of the window
    (JAX SwinBlock): LN, roll by -shift, window attention (with the -100
    shift mask when shifted), roll back, residual; LN, fc1, tanh-GELU,
    fc2, residual. Every op in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float, *, dtype=torch.float32,
                 use_pallas: bool = False, device=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = WindowAttention(dim, window_size, num_heads,
                                    use_pallas=use_pallas, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden, **kw)
        self.fc2 = Dense(hidden, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask_on(h, w, ws, shift, str(x.device))
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, h, w)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.fc2(_flax_gelu(self.fc1(self.norm2(x))))


class RSTB(nn.Module):
    """Residual Swin Transformer Block over NHWC: depth blocks (a
    FusedBlockStack, or with fused=False a list of SwinBlocks with shifts
    0 and ws/2 alternating), then a 1conv or 3conv (bottleneck)
    convolution, plus the residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float,
                 resi_connection: str = constants.R_CONNECTION_1CONV, *,
                 dtype=torch.float32, fused: bool = True,
                 use_pallas: bool = False, device=None):
        super().__init__()
        if fused:
            from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
            self.blocks = FusedBlockStack(dim, depth, num_heads,
                                          window_size, mlp_ratio,
                                          dtype=dtype, device=device)
        else:
            self.blocks = nn.Sequential(*(
                SwinBlock(dim, num_heads, window_size,
                          0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                          dtype=dtype, use_pallas=use_pallas, device=device)
                for i in range(depth)))
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
                 dtype=torch.float32, fused_blocks: bool = True,
                 use_pallas_attn: bool = False, device=None):
        super().__init__()
        self.in_chans, self.upscale = in_chans, upscale
        self.img_range, self.window_size = img_range, window_size
        self.upsampler, self.dtype = upsampler, dtype
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.fused_blocks = fused_blocks
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
                 fused=fused_blocks, use_pallas=use_pallas_attn, **kw)
            for d, nh in zip(depths, num_heads))
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
