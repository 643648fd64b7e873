"""Fused Swin block: forward, backward, the block pair and the tiled
(grouped) forward.

Port of srcaco2_tpu/ops/pallas/swin_block.py: the bias constants
(full_attn_mask_and_index, build_attn_bias), the q pre-scale, and five
kernels with their plain PyTorch versions:

  * K1, the block forward (`_fwd_kernel`): plain `swin_block_ref`, CUDA
    csrc/swin_block_fwd.cu;
  * K2, the block backward (`_bwd_kernel`): plain `swin_block_bwd_ref`,
    CUDA csrc/swin_block_bwd.cu;
  * K3, the pair forward (`_fwd_kernel_pair`): plain
    `swin_block_pair_ref`, CUDA csrc/swin_block_pair_fwd.cu;
  * K4, the pair backward (`_bwd_kernel_pair`): plain
    `swin_block_pair_bwd_ref`, CUDA csrc/swin_block_pair_bwd.cu;
  * K5, the grouped forward of the tiled path (`_fwd_kernel_grouped`):
    plain `swin_block_grouped_ref`, CUDA csrc/swin_block_grouped.cu.

`fused_swin_block` and `fused_swin_block_pair` are the training entries:
torch.autograd.Functions over K1 + K2 and K3 + K4 (the counterparts of
the JAX custom VJPs). A pair is a different function from two chained
blocks in bf16: block A's output reaches block B in f32, and the pair's
backward rounds where `_block_bwd_math` does, not where `_bwd_kernel`
does.

Numerics are fixed to the JAX package's production setting: f32 softmax
(SRCACO2_SWIN_F32_SOFTMAX's default) and tanh-GELU. Of the TPU knobs
the port carries one, SRCACO2_SWIN_PAIR (read by
models/swin_fused.FusedBlockStack, default off as in JAX), because it
selects K3 + K4 and their numerics; the tuning knobs are not carried
over. Head-lane padding (hd 30 -> 32) is exact and lives only in the
kernels' weight layouts (`pack_block_params`, `pack_block_bwd_params`).

Block parameters are a dict of tensors named as the port's state_dict
leaves: ln1_weight, ln1_bias, qkv_kernel (C, 3C), qkv_bias (3C,),
proj_kernel (C, C), proj_bias, ln2_weight, ln2_bias, mlp1_kernel
(C, ch), mlp1_bias, mlp2_kernel (ch, C), mlp2_bias. Dense kernels keep
the JAX (in, out) layout, so `x @ kernel` is the product.
"""
import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.ops.build import library

MAX_T = 256          # full-attention token cap of the training-patch path
NEG_INF = -1e9
LN_EPS = 1e-5        # torch nn.LayerNorm default
WINDOW = 8           # the CUDA kernels' window side (64-token windows)
_GC = 0.7978845608028654        # sqrt(2/pi)
_GA = 0.044715
BLOCK_KEYS = ('ln1_weight', 'ln1_bias', 'qkv_kernel', 'qkv_bias',
              'proj_kernel', 'proj_bias', 'ln2_weight', 'ln2_bias',
              'mlp1_kernel', 'mlp1_bias', 'mlp2_kernel', 'mlp2_bias')


@functools.lru_cache(maxsize=None)
def full_attn_mask_and_index(h: int, w: int, ws: int, shift: int):
    """(mask (T,T) f32 additive {0, NEG_INF}, rel_index (T,T) int32 into
    the (2ws-1)^2 bias table) in raster token order with the cyclic
    shift folded in: tokens attend iff they share a ws x ws window after
    the roll by -shift AND the same shift region (no attention across
    the wrap)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    yr = (ys - shift) % h
    xr = (xs - shift) % w
    win = (yr // ws) * (w // ws) + (xr // ws)

    def region(v, n):
        r = np.zeros_like(v)
        if shift > 0:
            r = np.where(v >= n - ws, 1, r)
            r = np.where(v >= n - shift, 2, r)
        return r

    reg = region(yr, h) * 3 + region(xr, w)
    same = (win[:, None] == win[None, :]) & (reg[:, None] == reg[None, :])
    mask = np.where(same, 0.0, NEG_INF).astype(np.float32)
    wy, wx = yr % ws, xr % ws
    dy = wy[:, None] - wy[None, :] + ws - 1
    dx = wx[:, None] - wx[None, :] + ws - 1
    rel = (dy * (2 * ws - 1) + dx).astype(np.int32)
    return mask, rel


@functools.lru_cache(maxsize=None)
def window_index(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws) int32: the raster token of each window's local row,
    windows in full_attn_mask_and_index's order. It is the roll by
    -shift and the window partition that the bias encodes: tokens of
    different windows never attend to each other there."""
    wy, wx = np.meshgrid(np.arange(h // ws), np.arange(w // ws),
                         indexing='ij')
    ly, lx = np.meshgrid(np.arange(ws), np.arange(ws), indexing='ij')
    ys = (wy.reshape(-1, 1) * ws + ly.reshape(1, -1) + shift) % h
    xs = (wx.reshape(-1, 1) * ws + lx.reshape(1, -1) + shift) % w
    return (ys * w + xs).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _mask_and_index_on(h: int, w: int, ws: int, shift: int, device: str):
    """full_attn_mask_and_index as tensors on `device`, copied there once
    (a copy per call would stall the host on every block). Normal
    tensors even when first asked for under inference_mode (an eval
    forward): the cache serves later autograd calls too."""
    mask, rel = full_attn_mask_and_index(h, w, ws, shift)
    with torch.inference_mode(False):
        return (torch.as_tensor(mask).to(device),
                torch.as_tensor(rel.reshape(-1), dtype=torch.long).to(device))


@functools.lru_cache(maxsize=64)
def _window_index_on(h: int, w: int, ws: int, shift: int, device: str):
    with torch.inference_mode(False):     # as _mask_and_index_on
        return torch.as_tensor(window_index(h, w, ws, shift)).to(device)


def build_attn_bias(tables: torch.Tensor, h: int, w: int, ws: int,
                    shifts=None) -> torch.Tensor:
    """tables: (d, (2ws-1)^2, nh). Returns the (d, nh, T, T) f32 bias
    (learned relative-position bias + window/shift mask); block i is
    shifted iff i is odd unless `shifts` gives the sequence. A gather
    (differentiable into `tables`): the JAX package's matmul
    factorization is bitwise equal to it."""
    d, _, nh = tables.shape
    t = h * w
    outs = []
    for i in range(d):
        shift = block_shift(i, ws) if shifts is None else shifts[i]
        mask, idx = _mask_and_index_on(h, w, ws, shift, str(tables.device))
        b = tables[i].float()[idx].reshape(t, t, nh).permute(2, 0, 1)
        outs.append(b + mask[None])
    return torch.stack(outs)


def block_shift(i: int, ws: int) -> int:
    """Cyclic shift of block i of a stage (SwinIR order)."""
    return 0 if i % 2 == 0 else ws // 2


def _prescale_cols(c: int, heads: int, like: torch.Tensor) -> torch.Tensor:
    """(3C,) column factors: hd**-0.5 on the q third, 1 elsewhere."""
    scale = (c // heads) ** -0.5
    return torch.cat([torch.full((c,), scale, dtype=like.dtype,
                                 device=like.device),
                      torch.ones(2 * c, dtype=like.dtype, device=like.device)])


def _prescale_qkv(wqkv: torch.Tensor, bqkv: torch.Tensor, heads: int):
    """Fold hd**-0.5 into the q third of the qkv weights and bias (any
    leading dims)."""
    colmul = _prescale_cols(wqkv.shape[-2], heads, wqkv)
    return wqkv * colmul, bqkv * colmul


def _ln_parts(x):
    """(xhat, rstd) of LayerNorm over the last axis, f32."""
    xc = x - x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def _ln(x, g, b):
    return _ln_parts(x)[0] * g + b


def _const(v: float, dtype) -> float:
    """A Python constant rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the array's type."""
    return float(torch.tensor(v, dtype=dtype))


def _gelu_tanh(u):
    """The tanh term of the tanh-GELU in u's dtype, one rounding per op,
    constants rounded to that dtype (as JAX evaluates it on a bf16
    array)."""
    gc, ga = _const(_GC, u.dtype), _const(_GA, u.dtype)
    return torch.tanh(gc * (u + ga * u * u * u))


def _gelu(u):
    """tanh-GELU evaluated in u's dtype, rounded as JAX rounds it."""
    return 0.5 * u * (1.0 + _gelu_tanh(u))


def _gelu_grad(u, th):
    """d gelu / du from u and its tanh term, in u's dtype with the JAX
    expression's order and rounding points (swin_block.py:_gelu_grad)."""
    gc, ga3 = _const(_GC, u.dtype), _const(3.0 * _GA, u.dtype)
    sech2 = 1.0 - th * th
    return 0.5 * (1.0 + th) + 0.5 * u * sech2 * gc * (1.0 + ga3 * u * u)


def _dot(a, b):
    """Product of compute-dtype operands with f32 accumulation."""
    return a.float() @ b.float()


def _fwd_math(xf, p, bias, heads, cdt, need_out=True):
    """Forward math of _block_fwd_math with the f32 softmax, over
    (n, T, C) f32 rows; p holds f32 params with qkv pre-scaled; bias is
    (n or 1, nh, T, T) f32. Returns (out f32 or None, intermediates)."""
    n, t, c = xf.shape
    hd = c // heads
    xhat1, rstd1 = _ln_parts(xf)
    y = (xhat1 * p['ln1_weight'] + p['ln1_bias']).to(cdt)
    qkv = _dot(y, p['wq'].to(cdt)).to(cdt) + p['bq'].to(cdt)
    q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = _dot(q, k.transpose(-1, -2)) + bias
    e = torch.exp(s - s.amax(-1, keepdim=True))
    rinv = 1.0 / e.sum(-1, keepdim=True)
    o = (_dot(e.to(cdt), v) * rinv).to(cdt)
    o = o.permute(0, 2, 1, 3).reshape(n, t, c)
    x2 = xf + (_dot(o, p['proj_kernel'].to(cdt)) + p['proj_bias'])
    xhat2, rstd2 = _ln_parts(x2)
    y2 = (xhat2 * p['ln2_weight'] + p['ln2_bias']).to(cdt)
    u = _dot(y2, p['mlp1_kernel'].to(cdt)).to(cdt) \
        + p['mlp1_bias'].to(cdt)
    th = _gelu_tanh(u)
    hact = 0.5 * u * (1.0 + th)         # _gelu(u), keeping th
    out = None
    if need_out:
        out = x2 + (_dot(hact, p['mlp2_kernel'].to(cdt)) + p['mlp2_bias'])
    inter = dict(y=y, xhat1=xhat1, rstd1=rstd1, q=q, k=k, v=v, e=e,
                 rinv=rinv, o=o, xhat2=xhat2, rstd2=rstd2, y2=y2, u=u,
                 th=th, hact=hact)
    return out, inter


def _f32_params(params: Dict[str, torch.Tensor], heads: int):
    p = {k: params[k].float() for k in BLOCK_KEYS}
    p['wq'], p['bq'] = _prescale_qkv(p['qkv_kernel'], p['qkv_bias'], heads)
    return p


def swin_block_ref(x: torch.Tensor, params: Dict[str, torch.Tensor],
                   bias: torch.Tensor, *, heads: int,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K1: full T x T attention with the
    (nh, T, T) bias and the rounding points of `_block_fwd_math`.
    x: (B, T, C). Returns x's dtype."""
    p = _f32_params(params, heads)
    out, _ = _fwd_math(x.float(), p, bias.float()[None], heads,
                       compute_dtype)
    return out.to(x.dtype)


def swin_block_grouped_ref(x: torch.Tensor, params: Dict[str, torch.Tensor],
                           bias_groups: torch.Tensor, gid: torch.Tensor, *,
                           heads: int,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K5: full T x T attention per tile with
    the tile's (nh, T, T) bias bias_groups[gid[tile]].
    x: (n_tiles, T, C); gid: (n_tiles,) int. Returns x's dtype."""
    p = _f32_params(params, heads)
    out, _ = _fwd_math(x.float(), p, bias_groups[gid.long()].float(),
                       heads, compute_dtype)
    return out.to(x.dtype)


def _ln_bwd(dy, g, xhat, rstd):
    """(dx, dgamma, dbeta) of LayerNorm over the last axis, f32."""
    dxhat = dy * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (dxhat - m1 - xhat * m2) * rstd
    return dx, (dy * xhat).sum(0), dy.sum(0)


def _bwd_math(g, it, p, heads, cdt, pair_rounding):
    """Backward of one block from its forward intermediates `it`
    (_fwd_math over (n, T, C) rows) and the f32 incoming grad g (n*T, C),
    which enters dbm2 and dx2 unrounded and the products rounded to cdt.
    du_c, dx2_c, do and the dq/dk/dv blocks round to the compute dtype;
    ds, the bias grad and every weight grad stay f32. The softmax
    backward's rounding set: `_bwd_kernel`'s heads-batched branch
    (swin_block.py:460-527, pair_rounding False) rounds 1/r, dp, rs and
    dp - rs to the compute dtype; `_block_bwd_math` (:583-628, the
    pair's, pair_rounding True) keeps them f32. The one departure from
    both: dbqkv sums the rounded dqkv in f32, where JAX rounds the sum
    to the compute dtype.

    Returns (dx (n*T, C) f32, {param name: f32 grad in the model
    layout}, dbias (nh, T, T) f32). The qkv grads are taken through the
    pre-scale, as XLA chains them after the custom VJP."""
    b, _, t, hd = it['q'].shape
    c = heads * hd
    m = b * t

    def rows(z):
        return z.reshape(m, z.shape[-1])

    gc = g.to(cdt)
    hact, y2, u, th = rows(it['hact']), rows(it['y2']), rows(it['u']), \
        rows(it['th'])
    dw2 = _dot(hact.t(), gc)
    dbm2 = g.sum(0)
    dh = _dot(gc, p['mlp2_kernel'].to(cdt).t())
    du = dh * _gelu_grad(u, th).float()
    du_c = du.to(cdt)
    dw1 = _dot(y2.t(), du_c)
    dbm1 = du.sum(0)
    dy2 = _dot(du_c, p['mlp1_kernel'].to(cdt).t())
    dx2_ln, dg2, db2 = _ln_bwd(dy2, p['ln2_weight'], rows(it['xhat2']),
                               rows(it['rstd2']))
    dx2 = g + dx2_ln
    dx2_c = dx2.to(cdt)
    o = rows(it['o'])
    dwproj = _dot(o.t(), dx2_c)
    dbproj = dx2.sum(0)
    do = _dot(dx2_c, p['proj_kernel'].to(cdt).t())
    do4 = do.to(cdt).reshape(b, t, heads, hd).transpose(1, 2)
    q, k, v, e, rinv = it['q'], it['k'], it['v'], it['e'], it['rinv']
    if pair_rounding:
        pr = e * rinv
        dp = _dot(do4, v.transpose(-1, -2))
        rs = (dp * pr).sum(-1, keepdim=True)
        ds = pr * (dp - rs)
    else:
        pr = e * rinv.to(cdt).float()
        dp = _dot(do4, v.transpose(-1, -2)).to(cdt)
        rs = (dp.float() * pr).sum(-1, keepdim=True)
        ds = pr * (dp - rs.to(cdt)).float()
    dv = _dot(pr.to(cdt).transpose(-1, -2), do4)
    dbias = ds.sum(0)
    dsc = ds.to(cdt)
    dq = _dot(dsc, k)
    dk = _dot(dsc.transpose(-1, -2), q)

    def merge(z):
        return z.to(cdt).transpose(1, 2).reshape(m, c)

    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], -1)
    dy = _dot(dqkv, p['wq'].to(cdt).t())
    colmul = _prescale_cols(c, heads, dy)
    dwqkv = _dot(rows(it['y']).t(), dqkv) * colmul
    dbqkv = dqkv.float().sum(0) * colmul
    dx_ln, dg1, db1 = _ln_bwd(dy, p['ln1_weight'], rows(it['xhat1']),
                              rows(it['rstd1']))
    grads = dict(ln1_weight=dg1, ln1_bias=db1, qkv_kernel=dwqkv,
                 qkv_bias=dbqkv, proj_kernel=dwproj, proj_bias=dbproj,
                 ln2_weight=dg2, ln2_bias=db2, mlp1_kernel=dw1,
                 mlp1_bias=dbm1, mlp2_kernel=dw2, mlp2_bias=dbm2)
    return dx2 + dx_ln, grads, dbias


def swin_block_bwd_ref(x: torch.Tensor, dout: torch.Tensor,
                       params: Dict[str, torch.Tensor], bias: torch.Tensor,
                       *, heads: int, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of K2: recompute the forward, then mirror
    `_bwd_kernel`'s heads-batched branch (swin_block.py:460-527) with
    the f32 softmax (see _bwd_math: 1/r, dp, rs and dp - rs round to
    the compute dtype).

    Returns (dx in x's dtype, {param name: f32 grad in the model
    layout}, dbias (nh, T, T) f32)."""
    p = _f32_params(params, heads)
    _, it = _fwd_math(x.float(), p, bias.float()[None], heads,
                      compute_dtype, need_out=False)
    dx, grads, dbias = _bwd_math(dout.float().reshape(-1, x.shape[-1]), it,
                                 p, heads, compute_dtype,
                                 pair_rounding=False)
    return dx.reshape(x.shape).to(x.dtype), grads, dbias


def swin_block_pair_ref(x: torch.Tensor, params_a: Dict[str, torch.Tensor],
                        bias_a: torch.Tensor,
                        params_b: Dict[str, torch.Tensor],
                        bias_b: torch.Tensor, *, heads: int,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K3 (`_fwd_kernel_pair`): block A, then
    block B on A's f32 output, unrounded; only B's output is rounded to
    x's dtype. x: (B, T, C)."""
    pa = _f32_params(params_a, heads)
    pb = _f32_params(params_b, heads)
    mid, _ = _fwd_math(x.float(), pa, bias_a.float()[None], heads,
                       compute_dtype)
    out, _ = _fwd_math(mid, pb, bias_b.float()[None], heads, compute_dtype)
    return out.to(x.dtype)


def swin_block_pair_bwd_ref(x: torch.Tensor, dout: torch.Tensor,
                            params_a: Dict[str, torch.Tensor],
                            bias_a: torch.Tensor,
                            params_b: Dict[str, torch.Tensor],
                            bias_b: torch.Tensor, *, heads: int,
                            compute_dtype=torch.bfloat16):
    """Plain PyTorch version of K4 (`_bwd_kernel_pair`): recompute A with
    its f32 output (B's input) and B, run B's backward from dout, then
    A's backward fed B's f32 dx, both with `_block_bwd_math`'s rounding
    set (see _bwd_math).

    Returns (dx in x's dtype, grads of A, dbias of A, grads of B, dbias
    of B), grads as swin_block_bwd_ref gives them."""
    cdt = compute_dtype
    pa = _f32_params(params_a, heads)
    pb = _f32_params(params_b, heads)
    mid, it_a = _fwd_math(x.float(), pa, bias_a.float()[None], heads, cdt)
    _, it_b = _fwd_math(mid, pb, bias_b.float()[None], heads, cdt,
                        need_out=False)
    dmid, grads_b, dbias_b = _bwd_math(dout.float().reshape(-1, x.shape[-1]),
                                       it_b, pb, heads, cdt,
                                       pair_rounding=True)
    dx, grads_a, dbias_a = _bwd_math(dmid, it_a, pa, heads, cdt,
                                     pair_rounding=True)
    return (dx.reshape(x.shape).to(x.dtype), grads_a, dbias_a, grads_b,
            dbias_b)


# -----------------------------------------------------------------
# the kernels' weight layouts
# -----------------------------------------------------------------


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


class _Pads(NamedTuple):
    c: int
    heads: int
    hd: int
    ch: int
    hp: int      # head width padded to 16
    ck: int      # C padded to 16 (the K of qkv and fc1)
    cn: int      # C padded to 8 (the N of proj and fc2)
    chp: int     # MLP hidden width padded to 16


def _pads(c: int, heads: int, ch: int) -> _Pads:
    hd = c // heads
    return _Pads(c, heads, hd, ch, _ceil(hd, 16), _ceil(c, 16), _ceil(c, 8),
                 _ceil(ch, 16))


class PackedBlock(NamedTuple):
    """Block parameters in the forward kernels' layout (any leading
    dims): products are `act @ W^T` with W stored (N, K) row-major, K
    padded to 16 and N to 8; head lanes padded hd -> hp (multiple of
    16)."""
    g1: torch.Tensor       # (C,) f32
    b1: torch.Tensor       # (C,) f32
    wqkv: torch.Tensor     # (heads, 3, hp, ck) cdt, q pre-scaled
    bqkv: torch.Tensor     # (heads, 3, hp) cdt
    wproj: torch.Tensor    # (cn, heads * hp) cdt
    bproj: torch.Tensor    # (C,) f32
    g2: torch.Tensor       # (C,) f32
    b2: torch.Tensor       # (C,) f32
    w1: torch.Tensor       # (chp, ck) cdt
    bm1: torch.Tensor      # (chp,) cdt
    w2: torch.Tensor       # (cn, chp) cdt
    bm2: torch.Tensor      # (C,) f32

    def block(self, i: int) -> 'PackedBlock':
        """Block i of parameters packed with a leading depth dim."""
        return PackedBlock(*(t[i] for t in self))


class PackedBwd(NamedTuple):
    """The backward kernel's extra weights (any leading dims): the
    transposes of the forward products, `grad @ W^T` with W stored
    (N, K) row-major and zero-padded the same way; qkv columns in the
    order (q|k|v, head, hp)."""
    wqkv_t: torch.Tensor   # (cn, 3 * heads * hp) cdt, q pre-scaled
    wproj_t: torch.Tensor  # (heads * hp, ck) cdt
    w1_t: torch.Tensor     # (cn, chp) cdt
    w2_t: torch.Tensor     # (chp, ck) cdt

    def block(self, i: int) -> 'PackedBwd':
        return PackedBwd(*(t[i] for t in self))


def _cast(t, dt):
    return t.to(dt).contiguous()


def pack_block_params(params: Dict[str, torch.Tensor], heads: int,
                      compute_dtype) -> PackedBlock:
    """Cast, pre-scale, transpose and zero-pad block parameters (with or
    without a leading depth dim) once for the forward kernels. Every pad
    is exact: zero weight rows/columns and zero biases add exact zeros.
    The result is detached: `fused_swin_block` carries the grads back to
    the model layout itself."""
    p = {k: v.detach().float() for k, v in params.items()}
    cdt = compute_dtype
    lead = p['qkv_kernel'].shape[:-2]
    pd = _pads(p['qkv_kernel'].shape[-2], heads, p['mlp1_kernel'].shape[-1])
    c, hd, ch, hp, ck, cn, chp = pd.c, pd.hd, pd.ch, pd.hp, pd.ck, pd.cn, \
        pd.chp
    wq, bq = _prescale_qkv(p['qkv_kernel'], p['qkv_bias'], heads)
    wq = wq.reshape(*lead, c, 3, heads, hd).movedim(-4, -1) \
        .transpose(-4, -3)                       # (heads, 3, hd, C)
    wq = F.pad(wq, (0, ck - c, 0, hp - hd))
    bq = F.pad(bq.reshape(*lead, 3, heads, hd).transpose(-3, -2),
               (0, hp - hd))
    wp = F.pad(p['proj_kernel'].reshape(*lead, heads, hd, c),
               (0, 0, 0, hp - hd)).reshape(*lead, heads * hp, c)
    wp = F.pad(wp.transpose(-1, -2), (0, 0, 0, cn - c))
    w1 = F.pad(p['mlp1_kernel'].transpose(-1, -2), (0, ck - c, 0, chp - ch))
    bm1 = F.pad(p['mlp1_bias'], (0, chp - ch))
    w2 = F.pad(p['mlp2_kernel'].transpose(-1, -2),
               (0, chp - ch, 0, cn - c))
    f32 = torch.float32
    return PackedBlock(
        _cast(p['ln1_weight'], f32), _cast(p['ln1_bias'], f32),
        _cast(wq, cdt), _cast(bq, cdt), _cast(wp, cdt),
        _cast(p['proj_bias'], f32),
        _cast(p['ln2_weight'], f32), _cast(p['ln2_bias'], f32),
        _cast(w1, cdt), _cast(bm1, cdt), _cast(w2, cdt),
        _cast(p['mlp2_bias'], f32))


def pack_block_bwd_params(params: Dict[str, torch.Tensor], heads: int,
                          compute_dtype) -> PackedBwd:
    """The backward kernel's weight layout (PackedBwd), detached, with or
    without a leading depth dim."""
    p = {k: v.detach().float() for k, v in params.items()}
    lead = p['qkv_kernel'].shape[:-2]
    pd = _pads(p['qkv_kernel'].shape[-2], heads, p['mlp1_kernel'].shape[-1])
    c, hd, ch, hp, ck, cn, chp = pd.c, pd.hd, pd.ch, pd.hp, pd.ck, pd.cn, \
        pd.chp
    wq, _ = _prescale_qkv(p['qkv_kernel'], p['qkv_bias'], heads)
    wq = F.pad(wq.reshape(*lead, c, 3, heads, hd), (0, hp - hd))
    wq = F.pad(wq.reshape(*lead, c, 3 * heads * hp), (0, 0, 0, cn - c))
    wp = F.pad(p['proj_kernel'].reshape(*lead, heads, hd, c),
               (0, ck - c, 0, hp - hd)).reshape(*lead, heads * hp, ck)
    w1 = F.pad(p['mlp1_kernel'], (0, chp - ch, 0, cn - c))
    w2 = F.pad(p['mlp2_kernel'], (0, ck - c, 0, chp - ch))
    cdt = compute_dtype
    return PackedBwd(_cast(wq, cdt), _cast(wp, cdt), _cast(w1, cdt),
                     _cast(w2, cdt))


def unpack_block_grads(gp: Dict[str, torch.Tensor], heads: int,
                       c: int, ch: int) -> Dict[str, torch.Tensor]:
    """The backward kernel's grads (padded layouts, qkv grads taken
    against the pre-scaled weights) -> grads of the model's f32
    parameters: pads dropped (their grads are exactly zero), the
    pre-scale chained."""
    pd = _pads(c, heads, ch)
    hd, hp = pd.hd, pd.hp
    colmul = _prescale_cols(c, heads, gp['dwqkv'])
    dwq = gp['dwqkv'].reshape(c, 3, heads, hp)[..., :hd].reshape(c, 3 * c)
    dbq = gp['dbqkv'].reshape(3, heads, hp)[..., :hd].reshape(3 * c)
    dwp = gp['dwproj'].reshape(heads, hp, c)[:, :hd].reshape(c, c)
    return dict(ln1_weight=gp['dg1'], ln1_bias=gp['db1'],
                qkv_kernel=dwq * colmul, qkv_bias=dbq * colmul,
                proj_kernel=dwp, proj_bias=gp['dbproj'],
                ln2_weight=gp['dg2'], ln2_bias=gp['db2'],
                mlp1_kernel=gp['dw1'], mlp1_bias=gp['dbm1'][:ch],
                mlp2_kernel=gp['dw2'], mlp2_bias=gp['dbm2'])


# -----------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------


def _bind(stem: str, entry: str, argtypes):
    lib = library(stem)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    name = lib.swin_error_name
    name.argtypes = [ctypes.c_int]
    name.restype = ctypes.c_char_p
    return fn, name


@functools.lru_cache(maxsize=None)
def _grouped_kernel():
    return _bind('swin_block_grouped', 'swin_block_grouped_fwd',
                 [ctypes.c_int] + [ctypes.c_void_p] * 16
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


# (compute_bf16, pointer table, n_img, t, c, heads, ch, stream)
_TABLE_ARGS = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fwd_kernel(stem: str):
    """K1 (swin_block_fwd) or K3 (swin_block_pair_fwd)."""
    return _bind(stem, stem, _TABLE_ARGS)


@functools.lru_cache(maxsize=None)
def _bwd_kernel(stem: str):
    """K2 (swin_block_bwd) or K4 (swin_block_pair_bwd), with the function
    that sizes its workspace."""
    fn, name = _bind(stem, stem, _TABLE_ARGS)
    ws = getattr(library(stem), f'{stem}_workspace')
    ws.argtypes = [ctypes.c_int] * 6
    ws.restype = ctypes.c_longlong
    return fn, name, ws


def _launch(fn, err_name, what, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{what} launch failed: CUDA error {rc} '
                           f'({err_name(rc).decode()})')


def _ptrs(tensors):
    """A host array of device pointers (the kernels' argument table)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_x(x, compute_dtype, heads):
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'compute dtype {compute_dtype}: bf16 or f32')
    if x.dtype != compute_dtype:
        raise ValueError(f'x is {x.dtype}, compute dtype {compute_dtype}:'
                         ' the kernels take x in the compute dtype')
    c = x.shape[-1]
    if c % heads or c % 2:
        raise ValueError(f'C={c} must be even and divisible by {heads}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')


def _check_packed(x, *packs):
    for packed in packs:
        for name, ten in packed._asdict().items():
            # the backward kernels copy weight rows 16 bytes at a time
            if (ten.device != x.device or not ten.is_contiguous()
                    or ten.data_ptr() % 16):
                raise ValueError(f'packed.{name} must be contiguous on '
                                 f'{x.device}, 16-byte aligned')


def _check_bias_window(x, bias, idx, heads):
    n, t, _ = x.shape
    if t not in (64, 128, 256):
        raise ValueError(f'T={t}: the kernels take T in (64, 128, 256)')
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (heads, t, t)
            or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError(f'bias must be a contiguous f32 ({heads}, {t}, '
                         f'{t}) tensor on {x.device}')
    nw = t // (WINDOW * WINDOW)
    if (idx.dtype != torch.int32 or tuple(idx.shape) != (nw, WINDOW ** 2)
            or idx.device != x.device or not idx.is_contiguous()):
        raise ValueError(f'window index must be a contiguous int32 ({nw}, '
                         f'{WINDOW ** 2}) tensor on {x.device}')


def _window_table(window, t, device):
    h, w, ws, shift = window
    if h * w != t:
        raise ValueError(f'window {window} does not cover T={t} tokens')
    if ws != WINDOW or h % ws or w % ws:
        raise ValueError(f'window side {ws} on {h}x{w}: the CUDA kernels '
                         f'take {WINDOW}x{WINDOW} windows')
    return _window_index_on(h, w, ws, shift, str(device))


def _check_dout(x, dout):
    if (dout.shape != x.shape or dout.dtype != x.dtype
            or dout.device != x.device or not dout.is_contiguous()):
        raise ValueError('dout must be contiguous and match x')


# the backward kernels' f32 grad outputs, in their pointer-table order
# (dbias follows)
_GRAD_ORDER = ('dwqkv', 'dbqkv', 'dwproj', 'dw1', 'dw2', 'dbm2', 'dbm1',
               'dg2', 'db2', 'dbproj', 'dg1', 'db1')


def _grad_buffers(x, heads: int, ch: int):
    """({grad name: empty f32 tensor in the kernels' padded layout},
    dbias (heads, T, T)) of one block's backward over x (n, T, C)."""
    _, t, c = x.shape
    pd = _pads(c, heads, ch)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    ca = heads * pd.hp
    gp = dict(dwqkv=f32(c, 3 * ca), dbqkv=f32(3 * ca), dwproj=f32(ca, c),
              dw1=f32(c, ch), dw2=f32(ch, c), dg1=f32(c), db1=f32(c),
              dg2=f32(c), db2=f32(c), dbproj=f32(c), dbm1=f32(pd.chp),
              dbm2=f32(c))
    return gp, f32(heads, t, t)


def swin_block_fwd(x: torch.Tensor, bias: torch.Tensor, idx: torch.Tensor,
                   packed: PackedBlock, *, heads: int,
                   compute_dtype) -> torch.Tensor:
    """K1 on the card: one Swin block over (B, T, C) patches in raster
    token order. `bias` (nh, T, T) f32 must come from build_attn_bias for
    the (h, w, ws, shift) that `idx` = window_index(h, w, ws, shift)
    encodes, with -1e9 on every pair outside a window: the kernel runs
    attention only inside each window (one CTA per 64-token window),
    which is the same function because exp(s - 1e9 - m) is 0 in f32."""
    _check_x(x, compute_dtype, heads)
    _check_packed(x, packed)
    _check_bias_window(x, bias, idx, heads)
    n, t, c = x.shape
    ch = packed.bm1.shape[-1]
    out = torch.empty_like(x)
    fn, err_name = _fwd_kernel('swin_block_fwd')
    ptrs = _ptrs([x, out, idx, bias, *packed])
    _launch(fn, err_name, 'swin_block_fwd',
            (int(compute_dtype == torch.bfloat16), ptrs, n, t, c, heads, ch),
            x.device)
    swin_block_fwd.launches += 1
    return out


swin_block_fwd.launches = 0


def swin_block_bwd(x: torch.Tensor, dout: torch.Tensor, bias: torch.Tensor,
                   idx: torch.Tensor, packed: PackedBlock,
                   packed_bwd: PackedBwd, *, heads: int, compute_dtype,
                   ch: int):
    """K2 on the card: recompute the block forward per 64-token window,
    then dx, the 12 weight grads and dbias. Two CUDA kernels: a
    per-window pass (dx, per-token operands, column-sum and dbias
    partials) and a reduction pass (the weight products A^T.B over every
    token, the sums, dbias), both deterministic. Same bias contract as
    `swin_block_fwd`; dbias is exactly zero off the window blocks.
    Returns (dx in x's dtype, {grad name: f32 tensor in the kernels'
    padded layout} as `unpack_block_grads` takes it, dbias)."""
    _check_x(x, compute_dtype, heads)
    _check_packed(x, packed, packed_bwd)
    _check_bias_window(x, bias, idx, heads)
    _check_dout(x, dout)
    n, t, c = x.shape
    bf = int(compute_dtype == torch.bfloat16)
    fn, err_name, ws_bytes = _bwd_kernel('swin_block_bwd')
    ws = torch.empty(int(ws_bytes(bf, n, t, c, heads, ch)),
                     dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    gp, dbias = _grad_buffers(x, heads, ch)
    ptrs = _ptrs([x, dout, dx, idx, bias, *packed, *packed_bwd, ws,
                  *(gp[k] for k in _GRAD_ORDER), dbias])
    _launch(fn, err_name, 'swin_block_bwd', (bf, ptrs, n, t, c, heads, ch),
            x.device)
    swin_block_bwd.launches += 1
    return dx, gp, dbias


swin_block_bwd.launches = 0


def swin_block_pair_fwd(x: torch.Tensor, bias_a: torch.Tensor,
                        idx_a: torch.Tensor, packed_a: PackedBlock,
                        bias_b: torch.Tensor, idx_b: torch.Tensor,
                        packed_b: PackedBlock, *, heads: int,
                        compute_dtype) -> torch.Tensor:
    """K3 on the card: blocks A then B over (B, T, C) patches in raster
    token order, one CTA per patch, A's output kept in f32 (a scratch
    array allocated here) and fed to B unrounded. Each block's bias and
    window index follow `swin_block_fwd`'s contract."""
    _check_x(x, compute_dtype, heads)
    _check_packed(x, packed_a, packed_b)
    _check_bias_window(x, bias_a, idx_a, heads)
    _check_bias_window(x, bias_b, idx_b, heads)
    n, t, c = x.shape
    ch = packed_a.bm1.shape[-1]
    out = torch.empty_like(x)
    mid = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    fn, err_name = _fwd_kernel('swin_block_pair_fwd')
    ptrs = _ptrs([x, out, mid, idx_a, bias_a, *packed_a, idx_b, bias_b,
                  *packed_b])
    _launch(fn, err_name, 'swin_block_pair_fwd',
            (int(compute_dtype == torch.bfloat16), ptrs, n, t, c, heads, ch),
            x.device)
    swin_block_pair_fwd.launches += 1
    return out


swin_block_pair_fwd.launches = 0


def swin_block_pair_bwd(x: torch.Tensor, dout: torch.Tensor,
                        bias_a: torch.Tensor, idx_a: torch.Tensor,
                        packed_a: PackedBlock, packed_bwd_a: PackedBwd,
                        bias_b: torch.Tensor, idx_b: torch.Tensor,
                        packed_b: PackedBlock, packed_bwd_b: PackedBwd, *,
                        heads: int, compute_dtype, ch: int):
    """K4 on the card: recompute A (with its f32 output) and B, then B's
    backward from dout and A's backward from B's f32 dx, with
    `_block_bwd_math`'s rounding points. Two CUDA kernels: a per-patch
    pass (three phases over the patch's windows) and K2's reduction pass
    over both blocks, both deterministic. Same bias contract as
    `swin_block_fwd`; each dbias is exactly zero off its window blocks.
    Returns (dx in x's dtype, A's grads, A's dbias, B's grads, B's
    dbias), grads as `swin_block_bwd` gives them."""
    _check_x(x, compute_dtype, heads)
    _check_packed(x, packed_a, packed_bwd_a, packed_b, packed_bwd_b)
    _check_bias_window(x, bias_a, idx_a, heads)
    _check_bias_window(x, bias_b, idx_b, heads)
    _check_dout(x, dout)
    n, t, c = x.shape
    bf = int(compute_dtype == torch.bfloat16)
    fn, err_name, ws_bytes = _bwd_kernel('swin_block_pair_bwd')
    ws = torch.empty(int(ws_bytes(bf, n, t, c, heads, ch)),
                     dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    gp_a, dbias_a = _grad_buffers(x, heads, ch)
    gp_b, dbias_b = _grad_buffers(x, heads, ch)
    ptrs = _ptrs([x, dout, dx, ws,
                  idx_a, bias_a, *packed_a, *packed_bwd_a,
                  *(gp_a[k] for k in _GRAD_ORDER), dbias_a,
                  idx_b, bias_b, *packed_b, *packed_bwd_b,
                  *(gp_b[k] for k in _GRAD_ORDER), dbias_b])
    _launch(fn, err_name, 'swin_block_pair_bwd',
            (bf, ptrs, n, t, c, heads, ch), x.device)
    swin_block_pair_bwd.launches += 1
    return dx, gp_a, dbias_a, gp_b, dbias_b


swin_block_pair_bwd.launches = 0


def fused_swin_block_grouped(x: torch.Tensor,
                             params: Dict[str, torch.Tensor],
                             bias_groups: torch.Tensor, gid: torch.Tensor,
                             *, heads: int, compute_dtype=torch.bfloat16,
                             packed: PackedBlock = None) -> torch.Tensor:
    """One Swin block over tiles with a bias group per tile, forward only.

    x: (n_tiles, T, C) tiles of 2ws x 2ws tokens in raster order;
    bias_groups: (G, nh, T, T) f32; gid: (n_tiles,) int32, each in
    [0, G). On a CPU tensor this is `swin_block_grouped_ref`. On a CUDA
    tensor it launches the CUDA kernel or raises; it has no backward, so
    it raises when grad mode is on and an input requires grad. `packed`
    (from pack_block_params) saves the per-call weight layout work."""
    if x.device.type == 'cpu':
        return swin_block_grouped_ref(x, params, bias_groups, gid,
                                      heads=heads,
                                      compute_dtype=compute_dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bias_groups, *params.values())):
        raise RuntimeError(
            'fused_swin_block_grouped has no backward: its output would '
            'carry no grad; run it under torch.no_grad() (the tiled path '
            'is for evaluation)')
    _check_x(x, compute_dtype, heads)
    n_tiles, t, c = x.shape
    ch = params['mlp1_kernel'].shape[-1]
    if t != 4 * WINDOW * WINDOW:
        raise ValueError(f'T={t}: the kernel takes 2ws x 2ws tiles with '
                         f'ws={WINDOW} (T={4 * WINDOW * WINDOW})')
    g = bias_groups.shape[0]
    if (bias_groups.dtype != torch.float32
            or tuple(bias_groups.shape) != (g, heads, t, t)
            or not bias_groups.is_contiguous()
            or bias_groups.device != x.device):
        raise ValueError('bias_groups must be a contiguous f32 (G, heads, '
                         f'{t}, {t}) tensor on {x.device}')
    if (gid.dtype != torch.int32 or tuple(gid.shape) != (n_tiles,)
            or gid.device != x.device or not gid.is_contiguous()):
        raise ValueError(f'gid must be a contiguous int32 ({n_tiles},) '
                         f'tensor on {x.device}')
    if packed is None:
        packed = pack_block_params(params, heads, compute_dtype)
    _check_packed(x, packed)
    out = torch.empty_like(x)
    fn, err_name = _grouped_kernel()
    _launch(fn, err_name, 'swin_block_grouped',
            (int(compute_dtype == torch.bfloat16),
             x.data_ptr(), out.data_ptr(), gid.data_ptr(),
             bias_groups.data_ptr(), *(ten.data_ptr() for ten in packed),
             n_tiles, g, c, heads, ch), x.device)
    fused_swin_block_grouped.launches += 1
    return out


fused_swin_block_grouped.launches = 0


# -----------------------------------------------------------------
# autograd
# -----------------------------------------------------------------


def _packed(pk, params, pack, heads, cdt):
    """The caller's packed weights `pk`, or `pack(params)` if it gave
    none."""
    return pk if pk is not None else pack(params, heads, cdt)


class _FusedBlock(torch.autograd.Function):
    """K1 forward, K2 backward (or their plain versions). Saves only x,
    the bias and the weights, as the JAX custom VJP does, and recomputes
    the rest in the backward."""

    @staticmethod
    def forward(ctx, x, bias, cfg, packs, *weights):
        heads, cdt, window, use_kernel = cfg
        params = dict(zip(BLOCK_KEYS, weights))
        ctx.cfg, ctx.packs = cfg, packs
        ctx.save_for_backward(x, bias, *weights)
        if not use_kernel:
            return swin_block_ref(x, params, bias, heads=heads,
                                  compute_dtype=cdt)
        idx = _window_table(window, x.shape[1], x.device)
        packed = _packed(packs[0], params, pack_block_params, heads, cdt)
        return swin_block_fwd(x, bias, idx, packed, heads=heads,
                              compute_dtype=cdt)

    @staticmethod
    def backward(ctx, dout):
        heads, cdt, window, use_kernel = ctx.cfg
        x, bias, *weights = ctx.saved_tensors
        params = dict(zip(BLOCK_KEYS, weights))
        dout = dout.contiguous()
        if use_kernel:
            c, ch = x.shape[-1], params['mlp1_kernel'].shape[-1]
            packed = _packed(ctx.packs[0], params, pack_block_params, heads,
                             cdt)
            packed_bwd = _packed(ctx.packs[1], params, pack_block_bwd_params,
                                 heads, cdt)
            idx = _window_table(window, x.shape[1], x.device)
            dx, gp, dbias = swin_block_bwd(
                x, dout, bias, idx, packed, packed_bwd, heads=heads,
                compute_dtype=cdt, ch=ch)
            grads = unpack_block_grads(gp, heads, c, ch)
        else:
            dx, grads, dbias = swin_block_bwd_ref(
                x, dout, params, bias, heads=heads, compute_dtype=cdt)
        return (dx, dbias, None, None,
                *(grads[k].to(params[k].dtype) for k in BLOCK_KEYS))


def fused_swin_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                     bias: torch.Tensor, *, heads: int,
                     window: Tuple[int, int, int, int],
                     compute_dtype=torch.bfloat16, packed=None,
                     packed_bwd=None, plain: bool = False) -> torch.Tensor:
    """One fused Swin block with its backward (K1 + K2).

    x: (B, T, C) in raster token order; params: the block's f32 model
    parameters (BLOCK_KEYS); bias: (nh, T, T) f32 from build_attn_bias
    for `window` = (h, w, ws, shift), with -1e9 on every pair outside a
    window. Grads: dx in x's dtype, f32 weight grads, dbias (nh, T, T)
    f32 (into build_attn_bias's gather, so into rel_pos_table).

    On CPU tensors (or with plain=True, which only a measurement uses to
    compare paths) it runs `swin_block_ref` / `swin_block_bwd_ref`. On a
    CUDA tensor it launches K1 and, in the backward, K2, or raises.
    `packed` / `packed_bwd` (pack_block_params / pack_block_bwd_params)
    save the per-call weight layout work."""
    use_kernel = x.device.type != 'cpu' and not plain
    cfg = (heads, compute_dtype, tuple(window), use_kernel)
    return _FusedBlock.apply(x, bias, cfg, (packed, packed_bwd),
                             *(params[k] for k in BLOCK_KEYS))


class _FusedPair(torch.autograd.Function):
    """K3 forward, K4 backward (or their plain versions). Saves only x,
    both biases and both weight sets, as the JAX custom VJP does, and
    recomputes the rest in the backward."""

    @staticmethod
    def forward(ctx, x, bias_a, bias_b, cfg, packs, *weights):
        heads, cdt, windows, use_kernel = cfg
        pa = dict(zip(BLOCK_KEYS, weights[:len(BLOCK_KEYS)]))
        pb = dict(zip(BLOCK_KEYS, weights[len(BLOCK_KEYS):]))
        ctx.cfg, ctx.packs = cfg, packs
        ctx.save_for_backward(x, bias_a, bias_b, *weights)
        if not use_kernel:
            return swin_block_pair_ref(x, pa, bias_a, pb, bias_b,
                                       heads=heads, compute_dtype=cdt)
        idx_a, idx_b = (_window_table(w, x.shape[1], x.device)
                        for w in windows)
        pk_a, pk_b = (_packed(pk, p, pack_block_params, heads, cdt)
                      for pk, p in zip(packs[0], (pa, pb)))
        return swin_block_pair_fwd(x, bias_a, idx_a, pk_a, bias_b, idx_b,
                                   pk_b, heads=heads, compute_dtype=cdt)

    @staticmethod
    def backward(ctx, dout):
        heads, cdt, windows, use_kernel = ctx.cfg
        x, bias_a, bias_b, *weights = ctx.saved_tensors
        pa = dict(zip(BLOCK_KEYS, weights[:len(BLOCK_KEYS)]))
        pb = dict(zip(BLOCK_KEYS, weights[len(BLOCK_KEYS):]))
        dout = dout.contiguous()
        if use_kernel:
            c, ch = x.shape[-1], pa['mlp1_kernel'].shape[-1]
            pk_a, pk_b = (_packed(pk, p, pack_block_params, heads, cdt)
                          for pk, p in zip(ctx.packs[0], (pa, pb)))
            pbw_a, pbw_b = (_packed(pk, p, pack_block_bwd_params, heads, cdt)
                            for pk, p in zip(ctx.packs[1], (pa, pb)))
            idx_a, idx_b = (_window_table(w, x.shape[1], x.device)
                            for w in windows)
            dx, gp_a, dbias_a, gp_b, dbias_b = swin_block_pair_bwd(
                x, dout, bias_a, idx_a, pk_a, pbw_a, bias_b, idx_b, pk_b,
                pbw_b, heads=heads, compute_dtype=cdt, ch=ch)
            grads_a = unpack_block_grads(gp_a, heads, c, ch)
            grads_b = unpack_block_grads(gp_b, heads, c, ch)
        else:
            dx, grads_a, dbias_a, grads_b, dbias_b = swin_block_pair_bwd_ref(
                x, dout, pa, bias_a, pb, bias_b, heads=heads,
                compute_dtype=cdt)
        return (dx, dbias_a, dbias_b, None, None,
                *(grads_a[k].to(pa[k].dtype) for k in BLOCK_KEYS),
                *(grads_b[k].to(pb[k].dtype) for k in BLOCK_KEYS))


def fused_swin_block_pair(x: torch.Tensor, params_a: Dict[str, torch.Tensor],
                          bias_a: torch.Tensor,
                          params_b: Dict[str, torch.Tensor],
                          bias_b: torch.Tensor, *, heads: int,
                          windows: Tuple[Tuple[int, int, int, int],
                                         Tuple[int, int, int, int]],
                          compute_dtype=torch.bfloat16, packed=(None, None),
                          packed_bwd=(None, None),
                          plain: bool = False) -> torch.Tensor:
    """Two chained Swin blocks A, B with their backward (K3 + K4), the
    counterpart of the JAX `fused_swin_block_pair`: A's output reaches B
    in f32, and the backward rounds as `_block_bwd_math` does.

    x: (B, T, C) in raster token order; params_a / params_b: each
    block's f32 model parameters (BLOCK_KEYS); bias_a / bias_b: (nh, T,
    T) f32 from build_attn_bias for windows[0] / windows[1] = (h, w, ws,
    shift), with -1e9 on every pair outside a window. Grads as
    `fused_swin_block`'s, for both blocks.

    On CPU tensors (or with plain=True, which only a measurement uses to
    compare paths) it runs `swin_block_pair_ref` /
    `swin_block_pair_bwd_ref`. On a CUDA tensor it launches K3 and, in
    the backward, K4, or raises. `packed` / `packed_bwd` hold each
    block's pack_block_params / pack_block_bwd_params (or None) and save
    the per-call weight layout work."""
    use_kernel = x.device.type != 'cpu' and not plain
    cfg = (heads, compute_dtype, tuple(tuple(w) for w in windows),
           use_kernel)
    return _FusedPair.apply(x, bias_a, bias_b, cfg,
                            (tuple(packed), tuple(packed_bwd)),
                            *(params_a[k] for k in BLOCK_KEYS),
                            *(params_b[k] for k in BLOCK_KEYS))
