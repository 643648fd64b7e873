"""FusedBlockStack: a stack of Swin blocks over stacked parameters
(port of srcaco2_tpu/models/swin_fused.py).

Paths, chosen from the input's shape, the module's training flag
(`model.train()` / `model.eval()`, the counterpart of JAX's `train`) and
the device:
  * fused (T = H*W <= 256, the training patches): every block is one
    call of ops/swin_block.fused_swin_block (K1 forward, K2 backward on
    the card; their plain versions on the CPU), with the cyclic shift
    and the window partition folded into the (nh, T, T) attention bias
    that build_attn_bias gathers from the bias tables. With
    SRCACO2_SWIN_PAIR=1 and an even depth, each (no-shift, shift) pair
    of blocks is one call of ops/swin_block.fused_swin_block_pair
    instead (K3 forward, K4 backward), a different function in bf16:
    the stream stays f32 inside the pair. This is the training path
    (`_pallas_path` in the JAX package).
  * tiled (evaluation only, H and W multiples of 2ws, T > 256): the
    image is cut into 2ws x 2ws tiles; the per-block cyclic shift, tile
    partition and group-major tile order fold into one token gather,
    and every block runs as one call of the grouped fused block
    (ops/swin_block.fused_swin_block_grouped: the CUDA kernel on the
    card, its plain version on the CPU). It has no backward, so a
    training module never takes it, as JAX's `allow_tiled = not train`.
    This is the serving path.
  * windowed (every other shape, training or evaluation, on any
    device, with autograd): the classic roll / window-partition
    formulation of JAX's `_windowed_path`, in eager torch ops (cuBLAS
    products on the card; JAX runs it through XLA, outside any Pallas
    kernel). It trains the default x2 / x4 patches (48x48 and 24x24 LR,
    T > 256) and evaluates images that are not multiples of 2ws.
The dispatch is JAX's (swin_fused.py:186-206), so no shape that JAX
accepts raises.

Parameters are stacked over depth d (leading dim), named as the JAX
leaves with LayerNorm `scale` -> `weight`; dense kernels keep the JAX
(in, out) layout.
"""
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.swinir import (_trunc_normal_,
                                             relative_position_index,
                                             shift_attn_mask,
                                             window_partition,
                                             window_reverse)
from srcaco2_tpu_torch.ops.swin_block import (BLOCK_KEYS, MAX_T, NEG_INF,
                                              LN_EPS, _dot, _gelu,
                                              block_shift, build_attn_bias,
                                              fused_swin_block,
                                              fused_swin_block_grouped,
                                              fused_swin_block_pair,
                                              pack_block_bwd_params,
                                              pack_block_params)


def _tile_group_masks(ws: int, shift: int) -> np.ndarray:
    """(4, T, T) extra edge masks of a 2x2-window tile, groups ordered
    (interior, right-edge, bottom-edge, corner): inside an image-edge
    window the shift wrap splits tokens into regions that must not
    attend to each other; cross-window pairs are masked by the base
    bias already."""
    tl = 2 * ws
    t = tl * tl
    ys, xs = np.meshgrid(np.arange(tl), np.arange(tl), indexing='ij')
    ys, xs = ys.ravel(), xs.ravel()
    win = (ys // ws) * 2 + xs // ws
    same_win = win[:, None] == win[None, :]

    def reg(v, edge):
        if not (edge and shift):
            return np.zeros(t, np.int64)
        band = (v // ws) == 1
        inner = (v % ws) < (ws - shift)
        return np.where(band, np.where(inner, 1, 2), 0)

    masks = []
    for ey, ex in ((0, 0), (0, 1), (1, 0), (1, 1)):
        rr = reg(ys, ey) * 3 + reg(xs, ex)
        same_reg = rr[:, None] == rr[None, :]
        masks.append(np.where(same_win & ~same_reg, NEG_INF, 0.0))
    return np.stack(masks).astype(np.float32)


class _TileLayout(NamedTuple):
    perm: np.ndarray      # (B*H*W,) gather: rolled, group-major tiles
    inv: np.ndarray       # (B*H*W,) inverse gather back to raster
    gid: np.ndarray       # (B*nt,) bias group of each tile


def _tile_layout(b: int, h: int, w: int, ws: int, shift: int) -> _TileLayout:
    """Token gather folding roll(-shift) + tile partition + group-major
    tile order (group, image, tile) into one index array, and each
    tile's bias group."""
    tl = 2 * ws
    nty, ntx = h // tl, w // tl
    ty, tx = np.meshgrid(np.arange(tl), np.arange(tl), indexing='ij')
    ty, tx = ty.ravel(), tx.ravel()

    def grp(i, j):
        return (2 if i == nty - 1 else 0) + (1 if j == ntx - 1 else 0)

    rows, gid = [], []
    for g in range(4):
        tiles = [(i, j) for i in range(nty) for j in range(ntx)
                 if grp(i, j) == g]
        for bi in range(b):
            for (i, j) in tiles:
                sr = (i * tl + ty + shift) % h
                sc = (j * tl + tx + shift) % w
                rows.append(bi * h * w + sr * w + sc)
                gid.append(g)
    perm = np.concatenate(rows).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return _TileLayout(perm, inv, np.asarray(gid, np.int32))


class _TilePlan(NamedTuple):
    perm0: torch.Tensor   # first gather, raster -> block 0's tiles
    trans: list           # per block: its tiles -> next block's tiles
    gids: list            # per block: (n_tiles,) int32 bias group
    masks: torch.Tensor   # (2, 4, 1, T, T) edge masks (no shift, shift)


class FusedBlockStack(nn.Module):
    """depth Swin blocks (shift 0 / ws//2 alternating) over stacked
    parameters. (B, H, W, C) in and out, H and W multiples of ws; the
    stream is carried in `dtype`. `pair` (SRCACO2_SWIN_PAIR at
    construction, default off as in JAX) runs the fused path's blocks
    as pairs."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.window_size, self.dtype = window_size, dtype
        d, c = depth, dim
        ch = int(c * mlp_ratio)
        nb = (2 * window_size - 1) ** 2
        shapes = {'ln1_weight': (d, c), 'ln1_bias': (d, c),
                  'qkv_kernel': (d, c, 3 * c), 'qkv_bias': (d, 3 * c),
                  'rel_pos_table': (d, nb, num_heads),
                  'proj_kernel': (d, c, c), 'proj_bias': (d, c),
                  'ln2_weight': (d, c), 'ln2_bias': (d, c),
                  'mlp1_kernel': (d, c, ch), 'mlp1_bias': (d, ch),
                  'mlp2_kernel': (d, ch, c), 'mlp2_bias': (d, c)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device)))
        # the block functions of the tiled and fused paths; a
        # measurement can swap in the plain versions to compare paths
        self.block_op = fused_swin_block_grouped
        self.fused_op = fused_swin_block
        self.pair_op = fused_swin_block_pair
        self.pair = os.environ.get('SRCACO2_SWIN_PAIR', '0') != '0'
        self._plans = {}
        self._win_plans = {}

    def reset_parameters(self, gen: torch.Generator):
        """LayerNorms at (1, 0), zero biases, truncated-normal dense
        kernels (std 1/sqrt(fan_in), flax lecun_normal) and bias tables
        (std 0.02)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith('ln') and name.endswith('weight'):
                    p.fill_(1.0)
                elif name.endswith('kernel') or name == 'rel_pos_table':
                    _trunc_normal_(p, 0.02 if name == 'rel_pos_table'
                                   else 1.0 / math.sqrt(p.shape[-2]), gen)
                else:
                    p.zero_()

    def _block_params(self):
        return {k: getattr(self, k) for k in BLOCK_KEYS}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        if h * w <= MAX_T:
            return self._fused_path(x)
        if (not self.training and 4 * ws * ws <= MAX_T
                and h % (2 * ws) == 0 and w % (2 * ws) == 0):
            return self._tiled_path(x)
        return self._windowed_path(x)

    def _fused_path(self, x: torch.Tensor) -> torch.Tensor:
        """T <= 256: one fused block (with backward) per depth step, or
        one fused pair per two with `pair` on and an even depth (odd
        depths keep the per-block path, as in JAX); the weights are
        packed for the kernels once per call."""
        b, h, w, c = x.shape
        ws, nh, cdt = self.window_size, self.num_heads, self.dtype
        t = h * w
        params = self._block_params()
        bias = build_attn_bias(self.rel_pos_table, h, w, ws)
        packed = packed_bwd = None
        if x.device.type == 'cuda':
            packed = pack_block_params(params, nh, cdt)
            if torch.is_grad_enabled():
                packed_bwd = pack_block_bwd_params(params, nh, cdt)

        def blk(i):
            return {k: v[i] for k, v in params.items()}

        def pk(pack, i):
            return None if pack is None else pack.block(i)

        def window(i):
            return (h, w, ws, block_shift(i, ws))

        carry = x.reshape(b, t, c).to(cdt).contiguous()
        if self.pair and self.depth % 2 == 0:
            for i in range(0, self.depth, 2):
                carry = self.pair_op(
                    carry, blk(i), bias[i], blk(i + 1), bias[i + 1],
                    heads=nh, windows=(window(i), window(i + 1)),
                    compute_dtype=cdt,
                    packed=(pk(packed, i), pk(packed, i + 1)),
                    packed_bwd=(pk(packed_bwd, i), pk(packed_bwd, i + 1)))
            return carry.reshape(b, h, w, c)
        for i in range(self.depth):
            carry = self.fused_op(
                carry, blk(i), bias[i], heads=nh, window=window(i),
                compute_dtype=cdt, packed=pk(packed, i),
                packed_bwd=pk(packed_bwd, i))
        return carry.reshape(b, h, w, c)

    def _plan(self, b: int, h: int, w: int, device) -> _TilePlan:
        key = (b, h, w, str(device))
        if key not in self._plans:
            ws, d = self.window_size, self.depth
            lays = (_tile_layout(b, h, w, ws, 0),
                    _tile_layout(b, h, w, ws, ws // 2))
            pars = [i % 2 for i in range(d)]
            trans = [lays[pars[i]].inv[lays[pars[i + 1]].perm]
                     if i < d - 1 else lays[pars[i]].inv
                     for i in range(d)]

            def dev(a):
                return torch.as_tensor(a).to(device)

            masks = np.stack([_tile_group_masks(ws, 0),
                              _tile_group_masks(ws, ws // 2)])[:, :, None]
            self._plans[key] = _TilePlan(
                dev(lays[0].perm), [dev(t) for t in trans],
                [dev(lays[p].gid) for p in pars], dev(masks))
        return self._plans[key]

    def _tiled_path(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, nh, cdt = self.window_size, self.num_heads, self.dtype
        tl = 2 * ws
        t = tl * tl
        nt = (h // tl) * (w // tl)
        plan = self._plan(b, h, w, x.device)
        params = self._block_params()
        rel_bias = build_attn_bias(self.rel_pos_table, tl, tl, ws,
                                   shifts=(0,) * self.depth)
        packed = (pack_block_params(params, nh, cdt)
                  if x.device.type == 'cuda' else None)
        carry = x.reshape(b * h * w, c).to(cdt)[plan.perm0]
        for i in range(self.depth):
            bias_g = (rel_bias[i][None] + plan.masks[i % 2]).contiguous()
            y = self.block_op(
                carry.reshape(b * nt, t, c),
                {k: v[i] for k, v in params.items()}, bias_g, plan.gids[i],
                heads=nh, compute_dtype=cdt,
                packed=None if packed is None else packed.block(i))
            carry = y.reshape(b * h * w, c)[plan.trans[i]]
        return carry.reshape(b, h, w, c)

    def _win_plan(self, h: int, w: int, device):
        """(relative position index (ws^4,), shift mask (nW, n, n) f32)
        on `device`, built once per (h, w, device) as `_plan` caches the
        tile layout; normal tensors even when first built under
        inference_mode (an eval forward), since training reuses them."""
        key = (h, w, str(device))
        if key not in self._win_plans:
            ws = self.window_size
            with torch.inference_mode(False):
                rel = torch.as_tensor(
                    relative_position_index(ws).reshape(-1),
                    dtype=torch.long).to(device)
                smask = torch.as_tensor(
                    shift_attn_mask(h, w, ws, ws // 2)).to(device)
            self._win_plans[key] = (rel, smask)
        return self._win_plans[key]

    def _windowed_path(self, x: torch.Tensor) -> torch.Tensor:
        """Classic shifted-window formulation, JAX's rounding points: f32
        LayerNorm and softmax, compute-dtype operands with f32 sums.
        With f32 compute the products must run in true f32 (TF32 off,
        as the caller sets: SRServer, the trainer)."""
        b, h, w, c = x.shape
        ws, nh, d, cdt = self.window_size, self.num_heads, self.depth, \
            self.dtype
        hd = c // nh
        n = ws * ws
        nw = (h // ws) * (w // ws)
        rel, smask = self._win_plan(h, w, x.device)

        def ln(z, g, bb):
            zf = z.float()
            mu = zf.mean(-1, keepdim=True)
            var = zf.var(-1, unbiased=False, keepdim=True)
            return ((zf - mu) * torch.rsqrt(var + LN_EPS) * g
                    + bb).to(cdt)

        def dense(z, k, bb):
            return (_dot(z.to(cdt), k.to(cdt)) + bb).to(cdt)

        carry = x.to(cdt)
        for i in range(d):
            p = {k: v[i].float() for k, v in self._block_params().items()}
            shift = 0 if i % 2 == 0 else ws // 2
            y = ln(carry, p['ln1_weight'], p['ln1_bias'])
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            qkv = dense(window_partition(y, ws), p['qkv_kernel'],
                        p['qkv_bias'])
            q, k, v = qkv.reshape(-1, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
            attn = _dot(q * hd ** -0.5, k.transpose(-1, -2))
            bias = self.rel_pos_table[i].float()[rel].reshape(n, n, nh)
            attn = attn + bias.permute(2, 0, 1)[None]
            if shift:
                attn = (attn.reshape(-1, nw, nh, n, n)
                        + smask[None, :, None]).reshape(-1, nh, n, n)
            attn = torch.softmax(attn, dim=-1)
            o = _dot(attn.to(cdt), v).to(cdt).permute(0, 2, 1, 3)
            o = dense(o.reshape(-1, n, c), p['proj_kernel'], p['proj_bias'])
            y = torch.roll(window_reverse(o, ws, h, w), (shift, shift),
                           dims=(1, 2))
            z = carry + y
            u = dense(ln(z, p['ln2_weight'], p['ln2_bias']),
                      p['mlp1_kernel'], p['mlp1_bias'])
            u = _gelu(u.float()).to(cdt)
            carry = z + dense(u, p['mlp2_kernel'], p['mlp2_bias'])
        return carry
