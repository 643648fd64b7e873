"""EDSR + LIIF, implicit neural representation SR (port of
srcaco2_tpu/models/edsr_liif.py): an EDSR backbone (16 resblocks of 64
features, no upsampling head) and the LIIF decoder (local ensemble,
feature unfolding and cell decoding), in the JAX module's factored
layout:

  * `dec_feat`: the decoder's first layer on the unfolded latent, run
    once in LR space as a 3x3 edge-padded conv (1x1 without
    feat_unfold);
  * `dec_relcell`: its part on the rel / cell constants, a bias-free
    dense layer on the query grid;
  * the per-query latent gather (`ensemble_gather`) of each of the 4
    ensemble branches, then one call of the decoder's tail over the 4
    stacked branches, and the branches weighted by the swapped-diagonal
    areas.

The query grid, the rel / cell constants and the area weights are built
with numpy exactly as the JAX module builds them (float64, then f32,
then the compute dtype), once per LR size and device. The gather is the
plain static gather z[:, iy][:, :, ix] (JAX's take path; its default
one-hot products are a TPU layout of the same copy). Its backward is a
deterministic segment sum over the static, monotone indices in f32,
rounded to the compute dtype after each axis as JAX's one-hot VJP
rounds its two products: no atomics, so two backward passes agree bit
for bit on the card. NCHW in and out; submodules carry the flax
names."""
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (Conv, Dense, FlaxNamed,
                                             ResBlock, raw_conv, reset_all)


def _segments(idx: np.ndarray, n: int) -> np.ndarray:
    """(n, m) positions of a monotone index vector's entries for each of
    its n values, padded with len(idx) (a zero row appended to the
    summed tensor); m is the largest count."""
    counts = np.bincount(idx, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    m = max(int(counts.max()), 1)
    k = np.arange(m)[None, :]
    return np.where(k < counts[:, None], starts[:, None] + k,
                    len(idx)).astype(np.int64)


def liif_plan(hl: int, wl: int, s: int, local_ensemble: bool,
              cell_decode: bool):
    """The JAX module's constants for an (hl, wl) LR input at scale s, as
    it builds them: per ensemble branch the row / column indices of the
    gather and the rel(/cell) inputs (hh, wh, 2 or 4) in f32; and the
    branches' area weights (hh, wh) in f32, diagonals swapped and
    normalised (None without the local ensemble)."""
    hh, wh = hl * s, wl * s
    yq = (np.arange(hh) + 0.5) / hh * 2 - 1
    xq = (np.arange(wh) + 0.5) / wh * 2 - 1
    yl = (np.arange(hl) + 0.5) / hl * 2 - 1
    xl = (np.arange(wl) + 0.5) / wl * 2 - 1
    iy0 = np.clip(((yq + 1) / 2 * hl - 0.5), 0, hl - 1)
    ix0 = np.clip(((xq + 1) / 2 * wl - 0.5), 0, wl - 1)
    offsets = [(-1, -1), (-1, 1), (1, -1), (1, 1)] \
        if local_ensemble else [(0, 0)]
    cell = np.array([2.0 / hh * hl, 2.0 / wh * wl], np.float32)
    branches, areas = [], []
    for vy, vx in offsets:
        iy = np.clip(np.round(iy0 + vy * 0.5), 0, hl - 1).astype(np.int32)
        ix = np.clip(np.round(ix0 + vx * 0.5), 0, wl - 1).astype(np.int32)
        rel_y = (yq - yl[iy]) * hl
        rel_x = (xq - xl[ix]) * wl
        rel = np.stack(np.meshgrid(rel_y, rel_x, indexing='ij'),
                       axis=-1).astype(np.float32)
        rc = rel
        if cell_decode:
            rc = np.concatenate([rel, np.broadcast_to(cell, rel.shape)], -1)
        branches.append((iy, ix, rc))
        areas.append(np.abs(rel[..., 0] / hl * rel[..., 1] / wl) + 1e-9)
    weights = None
    if local_ensemble:
        areas = [areas[3], areas[2], areas[1], areas[0]]
        tot = sum(areas)
        weights = [a / tot for a in areas]
    return branches, weights


@functools.lru_cache(maxsize=16)
def _plan_on(hl, wl, s, local_ensemble, cell_decode, device):
    """liif_plan's constants as tensors on `device` (with each gather's
    segment tables), copied there once; normal tensors even when first
    asked for under inference_mode, since a training step saves them."""
    branches, weights = liif_plan(hl, wl, s, local_ensemble, cell_decode)
    with torch.inference_mode(False):
        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        out = [dict(iy=t(iy, torch.int64), ix=t(ix, torch.int64),
                    seg_y=t(_segments(iy, hl)), seg_x=t(_segments(ix, wl)),
                    rc=t(rc)) for iy, ix, rc in branches]
        ws = None if weights is None else [t(w) for w in weights]
    return out, ws


def _segment_sum(g: torch.Tensor, dim: int, seg: torch.Tensor):
    """out[..., j, ...] = sum_k g[..., seg[j, k], ...] along `dim`, an
    entry equal to g.shape[dim] reading 0: a gather and a sum, in a fixed
    order (no atomics)."""
    n, m = seg.shape
    pad = list(g.shape)
    pad[dim] = 1
    gp = torch.cat([g, g.new_zeros(pad)], dim)
    shape = list(g.shape)
    shape[dim:dim + 1] = [n, m]
    return gp.index_select(dim, seg.reshape(-1)).reshape(shape).sum(dim + 1)


class _EnsembleGather(torch.autograd.Function):
    """lat[b, p, q, c] = z[b, iy[p], ix[q], c] for static monotone index
    vectors (NHWC z). The backward sums the cotangent over each column's
    queries, then over each row's, in f32 (`_segment_sum`), rounding to
    z's dtype after each: the transposed products of JAX's one-hot
    gather, each rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, z, iy, ix, seg_y, seg_x):
        ctx.save_for_backward(seg_y, seg_x)
        return z.index_select(1, iy).index_select(2, ix)

    @staticmethod
    def backward(ctx, g):
        seg_y, seg_x = ctx.saved_tensors
        zp = _segment_sum(g.float(), 2, seg_x).to(g.dtype)
        dz = _segment_sum(zp.float(), 1, seg_y).to(g.dtype)
        return dz, None, None, None, None


def ensemble_gather(z, iy, ix, seg_y, seg_x):
    """z[:, iy][:, :, ix] of an NHWC z, with the deterministic f32
    segment-sum backward (seg_y / seg_x: _segments of iy / ix)."""
    return _EnsembleGather.apply(z, iy, ix, seg_y, seg_x)


class EDSREncoder(FlaxNamed):
    def __init__(self, in_ch, n_feats=64, n_resblocks=16, res_scale=1.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_resblocks = n_resblocks
        self.child('Conv', Conv(in_ch, n_feats, 3, **kw))
        for _ in range(n_resblocks):
            self.child('ResBlock', ResBlock(n_feats, 3, res_scale, **kw))
        self.child('Conv', Conv(n_feats, n_feats, 3, **kw))

    def forward(self, x):
        y = self.Conv_0(x)
        res = y
        for i in range(self.n_resblocks):
            res = getattr(self, f'ResBlock_{i}')(res)
        return y + self.Conv_1(res)


class LIIFDecoderTail(FlaxNamed):
    """The decoder's layers 2..5 on the first layer's pre-activation:
    ReLU, three ReLU(Dense(hidden)), Dense(out_dim); NHWC."""

    def __init__(self, hidden=256, out_dim=1, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        for _ in range(3):
            self.child('Dense', Dense(hidden, hidden, **kw))
        self.child('Dense', Dense(hidden, out_dim, **kw))

    def forward(self, pre1):
        y = F.relu(pre1)
        for i in range(3):
            y = F.relu(getattr(self, f'Dense_{i}')(y))
        return self.Dense_3(y)


class EDSRLIIF(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, local_ensemble: bool = True,
                 feat_unfold: bool = True, cell_decode: bool = True,
                 hidden: int = 256, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.dtype = upscale, dtype
        self.local_ensemble, self.cell_decode = local_ensemble, cell_decode
        self.EDSREncoder_0 = EDSREncoder(in_chans, n_feats, n_resblocks,
                                         res_scale, **kw)
        # the latent part of the first layer: conv == W_f @ unfold(feat),
        # the edge pad matching the unfold's replicated borders
        k = 3 if feat_unfold else 1
        self.dec_feat = raw_conv(n_feats, hidden, k, pad_mode='replicate',
                                 **kw)
        self.dec_relcell = Dense(4 if cell_decode else 2, hidden,
                                 bias=False, **kw)
        self.decoder = LIIFDecoderTail(hidden, in_chans, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        hl, wl = x.shape[-2], x.shape[-1]
        feat = self.EDSREncoder_0(x)
        z = self.dec_feat(feat).permute(0, 2, 3, 1)        # B, hl, wl, hid
        branches, weights = _plan_on(hl, wl, self.upscale,
                                     self.local_ensemble, self.cell_decode,
                                     str(x.device))
        pre1s = []
        for br in branches:
            lat = ensemble_gather(z, br['iy'], br['ix'], br['seg_y'],
                                  br['seg_x'])             # B, hh, wh, hid
            pre1s.append(lat + self.dec_relcell(br['rc'])[None])
        # one call of the tail over the stacked ensemble branches
        preds = self.decoder(torch.cat(pre1s, 0)).chunk(len(branches), 0)
        if weights is None:
            out = preds[0]
        else:
            out = preds[0] * weights[0][None, ..., None].to(preds[0].dtype)
            for p, w in zip(preds[1:], weights[1:]):
                out = out + p * w[None, ..., None].to(p.dtype)
        return {'out': out.permute(0, 3, 1, 2)}
