"""Omni-SR, omni-axis (spatial + channel) self-attention network (port of
srcaco2_tpu/models/omnisr.py): res_num OSAG groups, each block_num OSA
blocks + a 1x1 conv + residual + ESA gate; an OSA block chains MBConv,
window attention, gated-conv FFN, windowed channel attention, FFN, grid
attention, FFN, grid channel attention, FFN. Zero pad to a window
multiple, one pixel-shuffle step. Convolutions run on NCHW; the
LayerNorms, window partitions and attention on NHWC. Submodules carry
the flax names."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (Conv, Dense, FlaxNamed, normal,
                                             pixel_shuffle, raw_conv,
                                             reset_all, to_nchw, to_nhwc)
from srcaco2_tpu_torch.models.swinir import (LayerNorm, _flax_gelu,
                                             _rel_index_on, _softmax)
from srcaco2_tpu_torch.ops import resize as R
from srcaco2_tpu_torch.ops.swin_block import _const

LN_EPS = 1e-6       # flax nn.LayerNorm's default


def _ln_nchw(ln, x):
    return to_nchw(ln(to_nhwc(x)))


def _silu(x):
    return x * torch.sigmoid(x)


class ESA(nn.Module):
    """Enhanced spatial attention gate."""

    def __init__(self, esa_channels: int, n_feats: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        f = esa_channels
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(n_feats, f, 1, **kw)
        self.Conv_1 = raw_conv(f, f, 3, stride=2, padding=0, **kw)
        self.Conv_2 = Conv(f, f, 3, **kw)
        self.Conv_3 = Conv(f, f, 1, **kw)
        self.Conv_4 = Conv(f, n_feats, 1, **kw)

    def forward(self, x):
        c1_ = self.Conv_0(x)
        c1 = self.Conv_1(c1_)
        # the reference's max_pool(7, stride 3), clamped for tiny inputs
        pk = min(7, c1.shape[-2], c1.shape[-1])
        c3 = self.Conv_2(F.max_pool2d(c1, pk, stride=3))
        c3 = R.resize2d(c3, x.shape[-2:], method=R.BILINEAR)
        c4 = self.Conv_4(c3 + self.Conv_3(c1_))
        return x * torch.sigmoid(c4)


class SqueezeExcitation(nn.Module):
    def __init__(self, dim: int, shrinkage_rate: float = 0.25, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        hidden = int(dim * shrinkage_rate)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.Dense_0 = Dense(dim, hidden, **kw)
        self.Dense_1 = Dense(hidden, dim, **kw)

    def forward(self, x):
        g = _silu(self.Dense_0(x.mean(dim=(-2, -1))))
        g = torch.sigmoid(self.Dense_1(g))
        return x * g[:, :, None, None]


class MBConv(nn.Module):
    def __init__(self, dim: int, expansion_rate: float = 1.0,
                 shrinkage_rate: float = 0.25, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        hidden = int(expansion_rate * dim)
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(dim, hidden, 1, **kw)
        self.Conv_1 = raw_conv(hidden, hidden, 3, groups=hidden, **kw)
        self.SqueezeExcitation_0 = SqueezeExcitation(hidden, shrinkage_rate,
                                                     **kw)
        self.Conv_2 = Conv(hidden, dim, 1, **kw)

    def forward(self, x):
        y = _flax_gelu(self.Conv_0(x))
        y = _flax_gelu(self.Conv_1(y))
        return self.Conv_2(self.SqueezeExcitation_0(y)) + x


def _window_split(x, w, grid: bool):
    """(B, H, W, C) -> (B*nW, w*w, C); grid=True groups by the dilated
    grid ('b d (w1 x) (w2 y)') instead of blocks ('b d (x w1) (y w2)')."""
    b, h, ww, c = x.shape
    if grid:
        x = x.reshape(b, w, h // w, w, ww // w, c).permute(0, 2, 4, 1, 3, 5)
    else:
        x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_merge(x, w, h, ww, grid: bool):
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, c)
    x = x.permute(0, 3, 1, 4, 2, 5) if grid else x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, c)


class SpatialAttention(nn.Module):
    """Window / grid MSA (heads of C/4 channels) with an optional
    relative position bias."""

    def __init__(self, dim: int, window_size: int, with_pe: bool,
                 grid: bool, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ws, self.grid, self.with_pe = window_size, grid, with_pe
        self.dim_head = dim // 4
        self.heads = dim // self.dim_head
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.Dense_0 = Dense(dim, 3 * dim, bias=False, **kw)
        if with_pe:
            self.rel_pos_bias = nn.Parameter(torch.empty(
                (2 * window_size - 1) ** 2, self.heads, device=device))
        self.Dense_1 = Dense(dim, dim, bias=False, **kw)

    def reset_parameters(self, gen: torch.Generator):
        if self.with_pe:
            normal(1.0)(self.rel_pos_bias, gen, None, None)

    def forward(self, x):
        b, c, h, w = x.shape
        ws, nh, dh = self.ws, self.heads, self.dim_head
        n = ws * ws
        yw = _window_split(self.LayerNorm_0(to_nhwc(x)), ws, self.grid)
        q, k, v = self.Dense_0(yw).reshape(-1, n, 3, nh, dh).permute(
            2, 0, 3, 1, 4)
        attn = torch.matmul(q * _const(dh ** -0.5, q.dtype),
                            k.transpose(-1, -2))
        if self.with_pe:
            idx = _rel_index_on(ws, str(x.device))
            bias = self.rel_pos_bias[idx].reshape(n, n, nh).permute(2, 0, 1)
            attn = attn + bias.to(attn.dtype)[None]
        out = torch.matmul(_softmax(attn), v)
        out = self.Dense_1(out.transpose(1, 2).reshape(-1, n, c))
        return to_nchw(_window_merge(out, ws, h, w, self.grid)) + x


class GatedConvFFN(nn.Module):
    def __init__(self, dim: int, mult: float = 1.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        hidden = int(dim * mult)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS, dtype=dtype,
                                     device=device)
        self.Conv_0 = raw_conv(dim, 2 * hidden, 1, **kw)
        self.Conv_1 = raw_conv(2 * hidden, 2 * hidden, 3,
                                groups=2 * hidden, **kw)
        self.Conv_2 = raw_conv(hidden, dim, 1, **kw)

    def forward(self, x):
        y = self.Conv_1(self.Conv_0(_ln_nchw(self.LayerNorm_0, x)))
        y1, y2 = y.chunk(2, dim=1)
        return self.Conv_2(_flax_gelu(y1) * y2) + x


class ChannelAttention(nn.Module):
    """Transposed (channel) attention within windows or grids."""

    def __init__(self, dim: int, heads: int, window_size: int, grid: bool,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.heads, self.ps, self.grid = heads, window_size, grid
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS, dtype=dtype,
                                     device=device)
        self.Conv_0 = raw_conv(dim, 3 * dim, 1, **kw)
        self.Conv_1 = raw_conv(3 * dim, 3 * dim, 3, groups=3 * dim, **kw)
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1,
                                                   device=device))
        self.Conv_2 = raw_conv(dim, dim, 1, **kw)

    def reset_parameters(self, gen: torch.Generator):
        del gen
        nn.init.ones_(self.temperature)

    def forward(self, x):
        b, c, h, w = x.shape
        ps, nh = self.ps, self.heads
        d = c // nh
        nw = (h // ps) * (w // ps)
        qkv = self.Conv_1(self.Conv_0(_ln_nchw(self.LayerNorm_0, x)))

        def to_tokens(t):
            # -> (b, groups, heads, d, tokens). Both variants take the
            # block partition; the grid variant swaps the roles of groups
            # and tokens (groups = offsets within a window, tokens =
            # windows), as JAX does
            tw = _window_split(to_nhwc(t), ps, False).reshape(
                b, nw, ps * ps, nh, d)
            return tw.permute(0, 2, 3, 4, 1) if self.grid \
                else tw.permute(0, 1, 3, 4, 2)

        qt, kt, vt = map(to_tokens, qkv.chunk(3, dim=1))
        qt = qt / torch.sqrt(torch.sum(qt * qt, -1, keepdim=True) + 1e-12)
        kt = kt / torch.sqrt(torch.sum(kt * kt, -1, keepdim=True) + 1e-12)
        attn = torch.matmul(qt, kt.transpose(-1, -2)) \
            * self.temperature.to(qt.dtype)
        out = torch.matmul(_softmax(attn), vt)          # (b, g, nh, d, t)
        if self.grid:
            out = out.permute(0, 4, 1, 2, 3).reshape(-1, ps * ps, c)
        else:
            out = out.permute(0, 1, 4, 2, 3).reshape(-1, ps * ps, c)
        out = to_nchw(_window_merge(out, ps, h, w, False))
        return self.Conv_2(out) + x


class OSABlock(nn.Module):
    def __init__(self, dim: int, window_size: int, with_pe: bool, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        w = window_size
        self.MBConv_0 = MBConv(dim, **kw)
        self.SpatialAttention_0 = SpatialAttention(dim, w, with_pe, False,
                                                   **kw)
        self.GatedConvFFN_0 = GatedConvFFN(dim, **kw)
        self.ChannelAttention_0 = ChannelAttention(dim, 4, w, False, **kw)
        self.GatedConvFFN_1 = GatedConvFFN(dim, **kw)
        self.SpatialAttention_1 = SpatialAttention(dim, w, with_pe, True,
                                                   **kw)
        self.GatedConvFFN_2 = GatedConvFFN(dim, **kw)
        self.ChannelAttention_1 = ChannelAttention(dim, 4, w, True, **kw)
        self.GatedConvFFN_3 = GatedConvFFN(dim, **kw)

    def forward(self, x):
        for m in (self.MBConv_0, self.SpatialAttention_0,
                  self.GatedConvFFN_0, self.ChannelAttention_0,
                  self.GatedConvFFN_1, self.SpatialAttention_1,
                  self.GatedConvFFN_2, self.ChannelAttention_1,
                  self.GatedConvFFN_3):
            x = m(x)
        return x


class OSAG(FlaxNamed):
    def __init__(self, dim: int, block_num: int, window_size: int, pe: bool,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.block_num = block_num
        for _ in range(block_num):
            self.child('OSABlock', OSABlock(dim, window_size, pe, **kw))
        self.child('Conv', raw_conv(dim, dim, 1, **kw))
        self.child('ESA', ESA(max(dim // 4, 16), dim, **kw))

    def forward(self, x):
        y = x
        for i in range(self.block_num):
            y = getattr(self, f'OSABlock_{i}')(y)
        return self.ESA_0(self.Conv_0(y) + x)


class OmniSR(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 num_feat: int = 64, res_num: int = 5, block_num: int = 4,
                 window_size: int = 8, pe: bool = True, bias: bool = True,
                 ffn_bias: bool = True, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        del bias, ffn_bias          # unused by the forward, as in JAX
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.ws, self.res_num = upscale, window_size, res_num
        self.dtype = dtype
        self.add_module('input', Conv(in_chans, num_feat, 3, **kw))
        for i in range(res_num):
            self.add_module(f'osag{i}', OSAG(num_feat, block_num,
                                             window_size, pe, **kw))
        self.output = Conv(num_feat, num_feat, 3, **kw)
        self.up = Conv(num_feat, in_chans * upscale ** 2, 3, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        h0, w0 = x.shape[-2], x.shape[-1]
        ws = self.ws
        ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        residual = self.input(x)
        out = residual
        for i in range(self.res_num):
            out = getattr(self, f'osag{i}')(out)
        out = self.output(out) + residual
        out = pixel_shuffle(self.up(out), self.upscale)
        return {'out': out[..., :h0 * self.upscale, :w0 * self.upscale]}
