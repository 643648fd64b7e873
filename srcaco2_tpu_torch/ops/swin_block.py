"""Grouped fused Swin block (forward, tiled full-image path).

Port of srcaco2_tpu/ops/pallas/swin_block.py: the bias constants
(full_attn_mask_and_index, build_attn_bias), the q pre-scale, the plain
PyTorch version `swin_block_grouped_ref` and the wrapper
`fused_swin_block_grouped` around the CUDA kernel
csrc/swin_block_grouped.cu (which replaces the Pallas
`_fwd_kernel_grouped`).

Numerics are fixed to the JAX package's production setting: f32 softmax
(SRCACO2_SWIN_F32_SOFTMAX's default) and tanh-GELU; the TPU tuning
knobs are not carried over. Head-lane padding (hd 30 -> 32) is exact
and lives only in the kernel's weight layout (`pack_block_params`).

Block parameters are a dict of tensors named as the port's state_dict
leaves: ln1_weight, ln1_bias, qkv_kernel (C, 3C), qkv_bias (3C,),
proj_kernel (C, C), proj_bias, ln2_weight, ln2_bias, mlp1_kernel
(C, ch), mlp1_bias, mlp2_kernel (ch, C), mlp2_bias. Dense kernels keep
the JAX (in, out) layout, so `x @ kernel` is the product.
"""
import ctypes
import functools
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.ops.build import library

MAX_T = 256          # full-attention token cap of the training-patch path
NEG_INF = -1e9
LN_EPS = 1e-5        # torch nn.LayerNorm default
WINDOW = 8           # the CUDA kernel's window side (T = 4 * 8^2 = 256)
_GC = 0.7978845608028654        # sqrt(2/pi)
_GA = 0.044715


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


@functools.lru_cache(maxsize=64)
def _mask_and_index_on(h: int, w: int, ws: int, shift: int, device: str):
    """full_attn_mask_and_index as tensors on `device`, copied there once
    (a copy per call would stall the host on every block)."""
    mask, rel = full_attn_mask_and_index(h, w, ws, shift)
    return (torch.as_tensor(mask).to(device),
            torch.as_tensor(rel.reshape(-1), dtype=torch.long).to(device))


def build_attn_bias(tables: torch.Tensor, h: int, w: int, ws: int,
                    shifts=None) -> torch.Tensor:
    """tables: (d, (2ws-1)^2, nh). Returns the (d, nh, T, T) f32 bias
    (learned relative-position bias + window/shift mask); block i is
    shifted iff i is odd unless `shifts` gives the sequence. A gather:
    the JAX package's matmul factorization is bitwise equal to it."""
    d, _, nh = tables.shape
    t = h * w
    outs = []
    for i in range(d):
        shift = (0 if i % 2 == 0 else ws // 2) if shifts is None \
            else shifts[i]
        mask, idx = _mask_and_index_on(h, w, ws, shift, str(tables.device))
        b = tables[i].float()[idx].reshape(t, t, nh).permute(2, 0, 1)
        outs.append(b + mask[None])
    return torch.stack(outs)


def _prescale_qkv(wqkv: torch.Tensor, bqkv: torch.Tensor, heads: int):
    """Fold hd**-0.5 into the q third of the qkv weights and bias (any
    leading dims)."""
    c = wqkv.shape[-2]
    scale = (c // heads) ** -0.5
    colmul = torch.cat([torch.full((c,), scale, dtype=wqkv.dtype,
                                   device=wqkv.device),
                        torch.ones(2 * c, dtype=wqkv.dtype,
                                   device=wqkv.device)])
    return wqkv * colmul, bqkv * colmul


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * g + b


def _gelu(u):
    """tanh-GELU evaluated in u's dtype, one rounding per op, constants
    rounded to that dtype (as JAX evaluates it on a bf16 array)."""
    gc = float(torch.tensor(_GC, dtype=u.dtype))
    ga = float(torch.tensor(_GA, dtype=u.dtype))
    return 0.5 * u * (1.0 + torch.tanh(gc * (u + ga * u * u * u)))


def _dot(a, b):
    """Product of compute-dtype operands with f32 accumulation."""
    return a.float() @ b.float()


def swin_block_grouped_ref(x: torch.Tensor, params: Dict[str, torch.Tensor],
                           bias_groups: torch.Tensor, gid: torch.Tensor, *,
                           heads: int,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the grouped block: full T x T attention
    per tile with the tile's (nh, T, T) bias bias_groups[gid[tile]].
    x: (n_tiles, T, C); gid: (n_tiles,) int. Returns x's dtype."""
    cdt = compute_dtype
    nt, t, c = x.shape
    hd = c // heads
    p = {k: v.float() for k, v in params.items()}
    wq, bq = _prescale_qkv(p['qkv_kernel'], p['qkv_bias'], heads)
    xf = x.float()
    y = _ln(xf, p['ln1_weight'], p['ln1_bias']).to(cdt)
    qkv = _dot(y, wq.to(cdt)).to(cdt) + bq.to(cdt)
    q, k, v = qkv.reshape(nt, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = _dot(q, k.transpose(-1, -2)) + bias_groups[gid.long()].float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    rinv = 1.0 / e.sum(-1, keepdim=True)
    o = (_dot(e.to(cdt), v) * rinv).to(cdt)
    o = o.permute(0, 2, 1, 3).reshape(nt, t, c)
    x2 = xf + (_dot(o, p['proj_kernel'].to(cdt)) + p['proj_bias'])
    y2 = _ln(x2, p['ln2_weight'], p['ln2_bias']).to(cdt)
    u = _dot(y2, p['mlp1_kernel'].to(cdt)).to(cdt) \
        + p['mlp1_bias'].to(cdt)
    out = x2 + (_dot(_gelu(u), p['mlp2_kernel'].to(cdt))
                + p['mlp2_bias'])
    return out.to(x.dtype)


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


class PackedBlock(NamedTuple):
    """Block parameters in the CUDA kernel's layout (any leading dims):
    products are `act @ W^T` with W stored (N, K) row-major, K padded to
    16 and N to 8; head lanes padded hd -> hp (multiple of 16)."""
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


def pack_block_params(params: Dict[str, torch.Tensor], heads: int,
                      compute_dtype) -> PackedBlock:
    """Cast, pre-scale, transpose and zero-pad block parameters (with or
    without a leading depth dim) once for the kernel. Every pad is
    exact: zero weight rows/columns and zero biases add exact zeros."""
    p = {k: v.detach().float() for k, v in params.items()}
    cdt = compute_dtype
    lead = p['qkv_kernel'].shape[:-2]
    c, ch = p['qkv_kernel'].shape[-2], p['mlp1_kernel'].shape[-1]
    hd = c // heads
    hp, ck, cn, chp = _ceil(hd, 16), _ceil(c, 16), _ceil(c, 8), \
        _ceil(ch, 16)
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

    def cast(t, dt):
        return t.to(dt).contiguous()

    f32 = torch.float32
    return PackedBlock(
        cast(p['ln1_weight'], f32), cast(p['ln1_bias'], f32),
        cast(wq, cdt), cast(bq, cdt), cast(wp, cdt),
        cast(p['proj_bias'], f32),
        cast(p['ln2_weight'], f32), cast(p['ln2_bias'], f32),
        cast(w1, cdt), cast(bm1, cdt), cast(w2, cdt),
        cast(p['mlp2_bias'], f32))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = library('swin_block_grouped')
    fn = lib.swin_block_grouped_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    name = lib.swin_block_grouped_error_name
    name.argtypes = [ctypes.c_int]
    name.restype = ctypes.c_char_p
    return fn, name


def fused_swin_block_grouped(x: torch.Tensor,
                             params: Dict[str, torch.Tensor],
                             bias_groups: torch.Tensor, gid: torch.Tensor,
                             *, heads: int, compute_dtype=torch.bfloat16,
                             packed: PackedBlock = None) -> torch.Tensor:
    """One Swin block over tiles with a bias group per tile.

    x: (n_tiles, T, C) tiles of 2ws x 2ws tokens in raster order;
    bias_groups: (G, nh, T, T) f32; gid: (n_tiles,) int32, each in
    [0, G). On a CPU tensor this is `swin_block_grouped_ref`. On a CUDA
    tensor it launches the CUDA kernel or raises; `packed` (from
    pack_block_params) saves the per-call weight layout work."""
    if x.device.type == 'cpu':
        return swin_block_grouped_ref(x, params, bias_groups, gid,
                                      heads=heads,
                                      compute_dtype=compute_dtype)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    n_tiles, t, c = x.shape
    ch = params['mlp1_kernel'].shape[-1]
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'compute dtype {compute_dtype}: bf16 or f32')
    if x.dtype != compute_dtype:
        raise ValueError(f'x is {x.dtype}, compute dtype {compute_dtype}:'
                         ' the kernel takes x in the compute dtype')
    if t != 4 * WINDOW * WINDOW:
        raise ValueError(f'T={t}: the kernel takes 2ws x 2ws tiles with '
                         f'ws={WINDOW} (T={4 * WINDOW * WINDOW})')
    if c % heads or c % 2:
        raise ValueError(f'C={c} must be even and divisible by {heads}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
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
    for name, ten in packed._asdict().items():
        if ten.device != x.device or not ten.is_contiguous():
            raise ValueError(f'packed.{name} must be contiguous on '
                             f'{x.device}')
    out = torch.empty_like(x)
    fn, err_name = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(int(compute_dtype == torch.bfloat16),
                x.data_ptr(), out.data_ptr(), gid.data_ptr(),
                bias_groups.data_ptr(),
                *(ten.data_ptr() for ten in packed),
                n_tiles, g, c, heads, ch, stream)
    if rc != 0:
        raise RuntimeError('swin_block_grouped launch failed: CUDA error '
                           f'{rc} ({err_name(rc).decode()})')
    fused_swin_block_grouped.launches += 1
    return out


fused_swin_block_grouped.launches = 0
