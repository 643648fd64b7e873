"""NLSN, non-local sparse attention network (port of
srcaco2_tpu/models/nlsn.py): an EDSR body of n_resblocks ResBlocks
(res_scale 0.1) with a NonLocalSparseAttention before the body and after
every 8th block, a body conv, the pixel-shuffle upsampler and a tail
conv. NCHW; submodules carry the flax names.

The attention hashes each position's embedding with random rotations
(LSH, n_hashes rounds), sorts the positions by bucket, attends within
chunks of the sorted order and their two neighbours, and blends the
rounds by their logsumexp scores. The JAX package gathers rows with an
exact one-hot matmul (a TPU gather is serial); here a row gather
(torch.take_along_dim), whose backward sums the n_hashes duplicates as
JAX's custom VJP does. Sorting is stable, as jnp.argsort is: the hash
codes tie within every bucket, and the order inside a bucket decides
the chunks.

Rotations. Each attention layer draws (1, C/4, n_hashes, buckets/2)
standard normals in f32 (their shape follows the image size), on the
CPU, then moves them to the input's device, so that the card and the
CPU hash alike:
  * `rotations` set (a list, one tensor per layer in call order): those
    (the tests inject JAX's);
  * else `lsh_generator` set (the train step's, seeded from the run's
    seed and the step number; train/steps.py): drawn from it, layer
    after layer;
  * else (evaluation) from a generator seeded 0 for each layer, so every
    layer hashes with the same rotation on every forward, as JAX's
    fixed key(0) gives. The port cannot reproduce JAX's threefry draws.
"""
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.blocks import (Conv, FlaxNamed, ResBlock,
                                             Upsampler, reset_all,
                                             stat_dtype, to_nchw, to_nhwc)


def hash_buckets(length: int, chunk: int) -> int:
    n = length // chunk
    return max(min(n + n % 2, 128), 2)


def lsh_sort(codes: torch.Tensor):
    """(indices, undo_sort) of the hash codes (B, S): the stable
    ascending order and its inverse permutation."""
    indices = torch.argsort(codes, dim=-1, stable=True)
    return indices, torch.argsort(indices, dim=-1, stable=True)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = t[b, idx[b, i]] for t (B, S, C) and idx (B, S')."""
    return torch.take_along_dim(t, idx[..., None], dim=1)


def _add_adjacent(t):
    """Each chunk's keys followed by the previous and the next chunk's
    (cyclic), along the within-chunk axis: (B, nh, K, 3 ck, C)."""
    back = torch.roll(t, 1, dims=2)
    fwd = torch.roll(t, -1, dims=2)
    return torch.cat([t, back, fwd], dim=3)


def _logsumexp(x):
    """jax.nn.logsumexp over the last axis (keepdims) in x's dtype: the
    max held without gradient, log of the sum of exp(x - max), plus the
    max."""
    amax = x.detach().amax(-1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = torch.exp(x - amax).to(stat_dtype(x.dtype)).sum(
        -1, keepdim=True).to(x.dtype)
    return torch.log(s) + amax


class NonLocalSparseAttention(nn.Module):
    def __init__(self, channels: int, n_hashes: int = 4,
                 chunk_size: int = 144, reduction: int = 4,
                 res_scale: float = 1.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_hashes, self.chunk, self.res_scale = n_hashes, chunk_size, \
            res_scale
        self.red_c = channels // reduction
        self.conv_match = Conv(channels, self.red_c, 3, **kw)
        self.conv_assembly = Conv(channels, channels, 1, **kw)

    def rotation_shape(self, length: int):
        return (1, self.red_c, self.n_hashes,
                hash_buckets(length, self.chunk) // 2)

    def hash_codes(self, x_embed: torch.Tensor, rot: torch.Tensor):
        """(B, nh * L) bucket codes, round r's offset by r * buckets."""
        b, length, _ = x_embed.shape
        nb = 2 * rot.shape[-1]
        rotated = torch.einsum('btf,fhi->bhti', x_embed,
                               rot[0].to(x_embed.dtype))
        rotated = torch.cat([rotated, -rotated], dim=-1)
        codes = torch.argmax(rotated, dim=-1)             # (B, nh, L)
        offsets = torch.arange(self.n_hashes, device=codes.device) * nb
        return (codes + offsets[None, :, None]).reshape(b, -1)

    def forward(self, x, rot: torch.Tensor):
        b, c, h, w = x.shape
        length, ck, nh = h * w, self.chunk, self.n_hashes
        x_embed = to_nhwc(self.conv_match(x)).reshape(b, length, self.red_c)
        y_embed = to_nhwc(self.conv_assembly(x)).reshape(b, length, c)

        codes = self.hash_codes(x_embed, rot)
        indices, undo_sort = lsh_sort(codes)
        mod_idx = indices % length
        xb = _rows(x_embed, mod_idx).reshape(b, nh, length, self.red_c)
        yb = _rows(y_embed, mod_idx).reshape(b, nh, length, c)

        pad = (ck - length % ck) % ck
        if pad > length:
            raise ValueError(f'{length} positions: the wrap-around padding '
                             f'to chunks of {ck} needs at least {ck // 2}')
        if pad:         # wrap-around padding to the chunk size
            xb = torch.cat([xb, xb[:, :, -pad:]], dim=2)
            yb = torch.cat([yb, yb[:, :, -pad:]], dim=2)
        nchunks = xb.shape[2] // ck
        xb = xb.reshape(b, nh, nchunks, ck, self.red_c)
        yb = yb.reshape(b, nh, nchunks, ck, c)

        x_match = xb / torch.sqrt(
            (xb * xb).to(stat_dtype(xb.dtype)).sum(-1, keepdim=True)
            .to(xb.dtype) + 2.5e-9)
        x_match = _add_adjacent(x_match)
        y_keys = _add_adjacent(yb)

        raw = torch.einsum('bhkie,bhkje->bhkij', xb, x_match)
        bucket_score = _logsumexp(raw)
        score = torch.exp(raw - bucket_score)
        ret = torch.einsum('bhkij,bhkje->bhkie', score, y_keys)

        ret = ret.reshape(b, nh, -1, c)
        bsc = bucket_score.reshape(b, nh, -1)
        if pad:
            ret, bsc = ret[:, :, :-pad], bsc[:, :, :-pad]
        ret = _rows(ret.reshape(b, -1, c), undo_sort)
        bsc = _rows(bsc.reshape(b, -1, 1), undo_sort)

        ret = ret.reshape(b, nh, length, c)
        bsc = bsc.reshape(b, nh, length, 1)
        e = torch.exp(bsc - bsc.detach().amax(1, keepdim=True))
        probs = e / e.to(stat_dtype(e.dtype)).sum(1, keepdim=True).to(
            e.dtype)
        out = (ret * probs).to(stat_dtype(ret.dtype)).sum(1).to(ret.dtype)
        out = to_nchw(out.reshape(b, h, w, c))
        # the attention output is scaled, not the residual input
        return self.res_scale * out + x


class NLSN(FlaxNamed):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 n_resblocks: int = 32, n_feats: int = 256,
                 n_hashes: int = 4, chunk_size: int = 144,
                 res_scale: float = 0.1, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.n_resblocks = n_resblocks
        self.rotations: Optional[List[torch.Tensor]] = None
        self.lsh_generator: Optional[torch.Generator] = None
        self.head = Conv(in_chans, n_feats, 3, **kw)

        def attn():
            return NonLocalSparseAttention(n_feats, n_hashes, chunk_size, 4,
                                           res_scale, **kw)
        self.child('NonLocalSparseAttention', attn())
        for i in range(n_resblocks):
            self.child('ResBlock', ResBlock(n_feats, 3, res_scale=res_scale,
                                            **kw))
            if (i + 1) % 8 == 0:
                self.child('NonLocalSparseAttention', attn())
        self.child('Conv', Conv(n_feats, n_feats, 3, **kw))
        self.child('Upsampler', Upsampler(upscale, n_feats, **kw))
        self.tail = Conv(n_feats, in_chans, 3, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def _rotation(self, layer: int, shape, device) -> torch.Tensor:
        if self.rotations is not None:
            rot = self.rotations[layer]
            rot = rot if torch.is_tensor(rot) else torch.from_numpy(
                np.array(rot, np.float32))
            if tuple(rot.shape) != tuple(shape):
                raise ValueError(f'rotation {layer}: {tuple(rot.shape)}, '
                                 f'the layer needs {tuple(shape)}')
        else:
            gen = self.lsh_generator or torch.Generator().manual_seed(0)
            rot = torch.randn(shape, generator=gen)
        return rot.to(device=device, dtype=torch.float32)

    def forward(self, x):
        y = self.head(x)
        length = y.shape[-2] * y.shape[-1]
        n_attn = 0

        def attend(t):
            nonlocal n_attn
            mod = getattr(self, f'NonLocalSparseAttention_{n_attn}')
            rot = self._rotation(n_attn, mod.rotation_shape(length),
                                 t.device)
            n_attn += 1
            return mod(t, rot)

        res = attend(y)
        for i in range(self.n_resblocks):
            res = getattr(self, f'ResBlock_{i}')(res)
            if (i + 1) % 8 == 0:
                res = attend(res)
        res = self.Conv_0(res)
        y = self.Upsampler_0(y + res)
        return {'out': self.tail(y)}
