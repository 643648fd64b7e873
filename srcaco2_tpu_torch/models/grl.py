"""GRL, global-regional-local restoration transformer (port of
srcaco2_tpu/models/grl.py, its windowed path).

Blocks (EfficientMixAttnTransformerBlock) with post-norm residuals
x + norm1(mixed_attn(x)) + CAB(x), then x + norm2(mlp(x)). The mixed
attention splits the channels half and half: shifted (even blocks) or
unshifted (odd blocks) window attention, and anchor stripe attention
(H stripes on even blocks, W stripes on odd), where anchors (the input
avg-pooled by the down factor, projected C -> C/2) attend the stripe's
keys and the stripe's queries then attend the anchors. Attention is
cosine attention with a learned, clamped logit scale and a continuous
position bias (an MLP 2 -> 512 -> heads over a log-spaced coordinate
table, 16 sigmoid). Per stage a conv and a residual; norm_start /
norm_end around the stages; the pixel-shuffle tail.

Left out, as the JAX package needs them for the TPU only or for
measurement: the merged 2ws-tile attention (SRCACO2_GRL_MERGED; the
plain windowed math stands for it, the merged tiles differ from it by
e^-100 leakage), the component ablations (SRCACO2_GRL_ABLATE) and the
scan with remat over block pairs (a plain loop of blocks here; the
bridge unstacks the scanned pairs' parameters onto `s{i}_b{j}`).

The position tables are numpy constants, copied from the JAX module
(the port imports nothing of it). The body runs on NHWC tokens; the
convolutions on NCHW.
"""
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.models.blocks import (Conv, Dense, FlaxNamed,
                                             Upsampler, UpsamplerDirect,
                                             reset_all, stat_dtype, to_nchw,
                                             to_nhwc)
from srcaco2_tpu_torch.models.swinir import LayerNorm, _flax_gelu, _softmax

LN_EPS = 1e-5
MASK_VALUE = -100.0


# ------------------------------------------------------- position tables
def _mesh_coords(hw) -> np.ndarray:
    ch, cw = np.meshgrid(np.arange(hw[0]), np.arange(hw[1]),
                         indexing='ij')
    return np.stack([ch.ravel(), cw.ravel()])       # 2, N


@functools.lru_cache(maxsize=64)
def rel_index(ws: Tuple[int, int], df: int = 1,
              window_to_anchor: bool = True) -> np.ndarray:
    """Pairwise relative-position index into the CPB table."""
    aws = (ws[0] // df, ws[1] // df)
    c_w = _mesh_coords(ws)
    c_a = _mesh_coords(aws)
    max_h_diff = aws[1] + ws[1] - 1
    if window_to_anchor:
        d = c_w[:, :, None] - c_a[:, None, :]
        off = (aws[0] - 1, aws[1] - 1)
    else:
        d = c_a[:, :, None] - c_w[:, None, :]
        off = (ws[0] - 1, ws[1] - 1)
    d = d.transpose(1, 2, 0).astype(np.int64)
    d[:, :, 0] += off[0]
    d[:, :, 1] += off[1]
    d[:, :, 0] *= max_h_diff
    return d.sum(-1)


@functools.lru_cache(maxsize=64)
def coords_table(ws: Tuple[int, int], df: int = 1) -> np.ndarray:
    """Continuous relative-coordinate table for the CPB MLP (log-spaced,
    in [-1, 1] scaled by 8)."""
    aws = (ws[0] // df, ws[1] // df)
    ts_p = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    ts_n = [-(w2 - 1) - (w1 - w2) // 2 for w1, w2 in zip(ws, aws)]
    ch = np.arange(ts_n[0], ts_p[0] + 1, dtype=np.float64)
    cw = np.arange(ts_n[1], ts_p[1] + 1, dtype=np.float64)
    t = np.stack(np.meshgrid(ch, cw, indexing='ij'), axis=-1)
    t[..., 0] /= max(ts_p[0], 1)
    t[..., 1] /= max(ts_p[1], 1)
    t *= 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8)
    return t.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=64)
def shift_mask(res: Tuple[int, int], ws: Tuple[int, int],
               ss: Tuple[int, int]) -> np.ndarray:
    """(nW, n, n): MASK_VALUE between tokens of a shifted window that come
    from different regions of the unshifted image, else 0."""
    m = np.zeros((1, res[0], res[1], 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws[0]), slice(-ws[0], -ss[0]),
               slice(-ss[0], None)):
        for wsl in (slice(0, -ws[1]), slice(-ws[1], -ss[1]),
                    slice(-ss[1], None)):
            m[:, hs, wsl, :] = cnt
            cnt += 1
    mw = m.reshape(1, res[0] // ws[0], ws[0], res[1] // ws[1], ws[1])
    mw = mw.transpose(0, 1, 3, 2, 4).reshape(-1, ws[0] * ws[1])
    d = mw[:, None, :] - mw[:, :, None]
    return np.where(d != 0, MASK_VALUE, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _on(name: str, key, device: str) -> torch.Tensor:
    """A table as a tensor on `device`, copied there once; a normal
    tensor even when first built under inference_mode."""
    fn = {'rel_index': rel_index, 'coords_table': coords_table,
          'shift_mask': shift_mask}[name]
    with torch.inference_mode(False):
        return torch.as_tensor(fn(*key)).to(device)


def win_part(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws0 * ws1, C), windows raster-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws[0] * ws[1], c)


def win_rev(x: torch.Tensor, ws, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws[0]) * (w // ws[1]))
    x = x.reshape(b, h // ws[0], w // ws[1], ws[0], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


# ------------------------------------ activations, backward rounded once
class _Sigmoid(torch.autograd.Function):
    """torch.sigmoid whose backward g (1 - y) y is computed in f32 and
    rounded once to the dtype, as the CPU computes it. CUDA's bf16
    sigmoid and tanh backward round after each of their operations (a
    third / a tenth of their outputs off the rounded float64 result in
    chip_smoke.py's op_replay); over GRL's 160 sigmoids (120 position
    biases, 40 channel gates) and 80 GELUs that made the card's bf16
    grads half again as noisy as the CPU's."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sigmoid(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        yf = y.to(stat_dtype(y.dtype))
        return (g.to(yf.dtype) * (1.0 - yf) * yf).to(g.dtype)


class _Tanh(torch.autograd.Function):
    """torch.tanh whose backward g (1 - y^2) is computed in f32 and
    rounded once (see _Sigmoid)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        yf = y.to(stat_dtype(y.dtype))
        return (g.to(yf.dtype) * (1.0 - yf * yf)).to(g.dtype)


def _gelu(u):
    return _flax_gelu(u, tanh=_Tanh.apply)


# --------------------------------------------------------------- modules
class AffineTransform(nn.Module):
    """Cosine-attention scaling (logit scale from log 10, clamped at
    log 100), continuous position bias (CPB MLP 2 -> 512 -> heads,
    16 sigmoid) and the optional mask."""

    def __init__(self, num_heads: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.heads = num_heads
        self.logit_scale = nn.Parameter(torch.full(
            (num_heads, 1, 1), math.log(10.0), device=device))
        self.cpb1 = Dense(2, 512, dtype=dtype, device=device)
        self.cpb2 = Dense(512, num_heads, bias=False, dtype=dtype,
                          device=device)

    def reset_parameters(self, gen: torch.Generator):
        del gen
        with torch.no_grad():
            self.logit_scale.fill_(math.log(10.0))

    def forward(self, attn, table, index, mask=None):
        scale = torch.exp(torch.clamp(self.logit_scale,
                                      max=math.log(1.0 / 0.01)))
        attn = attn * scale.to(attn.dtype)
        h = self.cpb2(F.relu(self.cpb1(table)))
        n1, n2 = index.shape
        # the gather through f32 (exact both ways): its backward, a
        # scatter-add of n1 n2 rows into the table, sums in f32 and
        # rounds once, where a bf16 index_put rounds every addition
        bias = h.float()[index.reshape(-1)].to(h.dtype).reshape(
            n1, n2, self.heads)
        bias = 16.0 * _Sigmoid.apply(bias.permute(2, 0, 1))
        attn = attn + bias.to(attn.dtype)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(-1, nw, *attn.shape[1:]) \
                + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(-1, *attn.shape[2:])
        return attn


def _cosine_attn(q, k, v, transform, table, index, mask=None):
    qn = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    kn = k / torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    attn = torch.matmul(qn, kn.transpose(-2, -1))
    attn = _softmax(transform(attn, table, index, mask))
    return torch.matmul(attn, v)


class MixedAttention(nn.Module):
    def __init__(self, dim: int, num_heads_w: int, num_heads_s: int,
                 window_size: int, window_shift: bool,
                 stripe_size: Tuple[int, int], stripe_type: str, df: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads_w, self.heads_s, self.df = num_heads_w, num_heads_s, df
        self.ws = window_size
        self.shift = window_size // 2 if window_shift else 0
        self.ss = tuple(stripe_size if stripe_type == 'H'
                        else stripe_size[::-1])
        self.qkv = Dense(dim, 3 * dim, **kw)
        self.affine_w = AffineTransform(num_heads_w, **kw)
        self.anchor_proj = Dense(dim, dim // 2, **kw)
        self.affine_s1 = AffineTransform(num_heads_s, **kw)
        self.affine_s2 = AffineTransform(num_heads_s, **kw)
        self.proj = Dense(dim, dim, **kw)

    def _table(self, name, *key):
        return _on(name, key, str(self.qkv.weight.device))

    def forward(self, x):
        b, h, w, c = x.shape
        qkv = self.qkv(x)
        qkv_w, qkv_s = qkv.chunk(2, dim=-1)          # each 3 C / 2
        ws, shift = (self.ws, self.ws), self.shift

        # window attention half
        n, hd = ws[0] * ws[1], (c // 2) // self.heads_w
        yw = torch.roll(qkv_w, (-shift, -shift), (1, 2)) if shift else qkv_w
        t3 = win_part(yw, ws).reshape(-1, n, 3, self.heads_w, hd) \
            .permute(2, 0, 3, 1, 4)
        mask = self._table('shift_mask', (h, w), ws, (shift, shift)) \
            if shift else None
        out_w = _cosine_attn(
            t3[0], t3[1], t3[2], self.affine_w,
            self._table('coords_table', ws, 1),
            self._table('rel_index', ws, 1, True), mask)
        out_w = win_rev(out_w.transpose(1, 2).reshape(-1, n, c // 2), ws,
                        h, w)
        if shift:
            out_w = torch.roll(out_w, (shift, shift), (1, 2))

        # anchor stripe attention half
        ss, df = self.ss, self.df
        a_ss = (ss[0] // df, ss[1] // df)
        n1, n2 = ss[0] * ss[1], a_ss[0] * a_ss[1]
        hds = (c // 2) // self.heads_s
        t3 = win_part(qkv_s, ss).reshape(-1, n1, 3, self.heads_s, hds) \
            .permute(2, 0, 3, 1, 4)
        qs, ks, vs = t3[0], t3[1], t3[2]
        pooled = to_nhwc(F.avg_pool2d(to_nchw(x), df, df))
        anchor = self.anchor_proj(pooled)
        a4 = win_part(anchor, a_ss).reshape(-1, n2, self.heads_s, hds) \
            .transpose(1, 2)
        table = self._table('coords_table', ss, df)
        # anchors attend the stripe (a2w), then the stripe the anchors
        y1 = _cosine_attn(a4, ks, vs, self.affine_s1, table,
                          self._table('rel_index', ss, df, False))
        y2 = _cosine_attn(qs, a4, y1, self.affine_s2, table,
                          self._table('rel_index', ss, df, True))
        out_s = win_rev(y2.transpose(1, 2).reshape(-1, n1, c // 2), ss, h, w)
        return self.proj(torch.cat([out_w, out_s], dim=-1))


class CAB(FlaxNamed):
    """Local connection: conv-GELU-conv, then RCAN channel attention;
    NCHW."""

    def __init__(self, num_feat: int, compress_ratio: int = 4,
                 reduction: int = 18, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        mid, red = num_feat // compress_ratio, max(1, num_feat // reduction)
        self.child('Conv', Conv(num_feat, mid, 3, **kw))
        self.child('Conv', Conv(mid, num_feat, 3, **kw))
        self.child('Conv', Conv(num_feat, red, 1, **kw))
        self.child('Conv', Conv(red, num_feat, 1, **kw))

    def forward(self, x):
        y = self.Conv_1(_gelu(self.Conv_0(x)))
        g = y.mean(dim=(-2, -1), keepdim=True)
        g = _Sigmoid.apply(self.Conv_3(F.relu(self.Conv_2(g))))
        return y * g


class GRLBlock(FlaxNamed):
    def __init__(self, dim: int, num_heads_w: int, num_heads_s: int,
                 window_size: int, window_shift: bool,
                 stripe_size: Tuple[int, int], stripe_type: str, df: int,
                 mlp_ratio: float, local_connection: bool, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.child('MixedAttention', MixedAttention(
            dim, num_heads_w, num_heads_s, window_size, window_shift,
            stripe_size, stripe_type, df, **kw))
        self.child('LayerNorm', LayerNorm(dim, eps=LN_EPS, **kw))
        self.local_connection = local_connection
        if local_connection:
            self.child('CAB', CAB(dim, **kw))
        hidden = int(dim * mlp_ratio)
        self.child('Dense', Dense(dim, hidden, **kw))
        self.child('Dense', Dense(hidden, dim, **kw))
        self.child('LayerNorm', LayerNorm(dim, eps=LN_EPS, **kw))

    def forward(self, x):
        """x: (B, H, W, C)."""
        attn = self.LayerNorm_0(self.MixedAttention_0(x))
        if self.local_connection:
            x = x + attn + to_nhwc(self.CAB_0(to_nchw(x)))
        else:
            x = x + attn
        y = self.Dense_1(_gelu(self.Dense_0(x)))
        return x + self.LayerNorm_1(y)


class GRL(nn.Module):
    """Blocks `s{i}_b{j}`: block j of stage i shifts its windows and
    takes H stripes when j is even, neither when it is odd."""

    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 img_range: float = 1.0, window_size: int = 8,
                 embed_dim: int = 180,
                 depths: Sequence[int] = (4, 4, 8, 8, 8, 4, 4),
                 num_heads_window: Sequence[int] = (3,) * 7,
                 num_heads_stripe: Sequence[int] = (3,) * 7,
                 mlp_ratio: float = 2.0,
                 stripe_size: Tuple[int, int] = (8, 8),
                 anchor_window_down_factor: int = 2,
                 local_connection: bool = True,
                 upsampler: str = constants.US_PIXEL_SHUFFLE, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.img_range, self.dtype = upscale, img_range, dtype
        self.pad_unit = max(window_size, *stripe_size)
        self.depths = tuple(depths)
        self.upsampler = upsampler
        e = embed_dim
        self.conv_first = Conv(in_chans, e, 3, **kw)
        self.norm_start = LayerNorm(e, eps=LN_EPS, **kw)
        for si, (d, nhw, nhs) in enumerate(zip(depths, num_heads_window,
                                               num_heads_stripe)):
            for i in range(d):
                self.add_module(f's{si}_b{i}', GRLBlock(
                    e, nhw, nhs, window_size, i % 2 == 0,
                    tuple(stripe_size), 'H' if i % 2 == 0 else 'W',
                    anchor_window_down_factor, mlp_ratio, local_connection,
                    **kw))
            self.add_module(f's{si}_conv', Conv(e, e, 3, **kw))
        self.norm_end = LayerNorm(e, eps=LN_EPS, **kw)
        self.conv_after_body = Conv(e, e, 3, **kw)
        if upsampler == constants.US_PIXEL_SHUFFLE:
            self.conv_before_up = Conv(e, 64, 3, **kw)
            self.Upsampler_0 = Upsampler(upscale, 64, **kw)
            self.conv_last = Conv(64, in_chans, 3, **kw)
        elif upsampler == constants.US_PIXEL_SHUFFLE_DIRECT:
            self.UpsamplerDirect_0 = UpsamplerDirect(upscale, e, in_chans,
                                                     **kw)
        else:
            raise NotImplementedError(upsampler)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        x = x * self.img_range          # the mean is 0 (one channel)
        h0, w0 = x.shape[-2:]
        u = self.pad_unit
        ph, pw = (u - h0 % u) % u, (u - w0 % u) % u
        if ph or pw:
            # constant-zero padding, as the reference's check_image_size
            x = F.pad(x, (0, pw, 0, ph))
        feat = self.conv_first(x)
        body = self.norm_start(to_nhwc(feat))
        for si, d in enumerate(self.depths):
            stage_in = body
            for i in range(d):
                body = getattr(self, f's{si}_b{i}')(body)
            body = to_nhwc(getattr(self, f's{si}_conv')(to_nchw(body))) \
                + stage_in
        body = self.conv_after_body(to_nchw(self.norm_end(body)))
        feat = feat + body
        if self.upsampler == constants.US_PIXEL_SHUFFLE:
            u = F.leaky_relu(self.conv_before_up(feat), 0.01)
            out = self.conv_last(self.Upsampler_0(u))
        else:
            out = self.UpsamplerDirect_0(feat)
        out = out[..., :h0 * self.upscale, :w0 * self.upscale]
        return {'out': out / self.img_range}
