"""ENLCN, efficient non-local contrastive network (port of
srcaco2_tpu/models/enlcn.py): an EDSR body of 32 ResBlocks with ENLCA
attention before the body and after every 8th block; pixel-shuffle tail.
ENLCA is kernelized (Performer-style) linear attention: q / k
l2-normalized times sqrt(6), softmax-kernel features through a fixed
Gaussian-orthogonal projection of 128 rows, then O(N) attention.

The projection: JAX draws it from jax.random.key(42) on every call,
which torch cannot reproduce. The port keeps it as a persistent,
non-trainable buffer of each ENLCA (`proj`, as the reference keeps it),
drawn at construction by the same construction from a torch.Generator
seeded 42. bridge.flax_to_torch can fill it from the JAX matrix; then
the two packages compute the same function, and the port's checkpoints
carry it. A freshly built port ENLCN differs from a fresh JAX one in
this buffer only. NCHW convolutions; submodules carry the flax names."""
import math

import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.blocks import (Conv, FlaxNamed, ResBlock,
                                             Upsampler, reset_all)

PROJECTION_SEED = 42


def gaussian_orthogonal_random_matrix(gen: torch.Generator, nb_rows: int,
                                      nb_cols: int) -> torch.Tensor:
    """Stacked orthogonalized Gaussian blocks with chi-distributed row
    norms (Performer FAVOR+), f32 on the CPU."""
    nb_full = nb_rows // nb_cols
    blocks = []
    for _ in range(nb_full):
        q, _ = torch.linalg.qr(torch.randn(nb_cols, nb_cols, generator=gen))
        blocks.append(q.T)
    rem = nb_rows - nb_full * nb_cols
    if rem > 0:
        q, _ = torch.linalg.qr(torch.randn(nb_cols, nb_cols, generator=gen))
        blocks.append(q.T[:rem])
    norms = torch.linalg.norm(torch.randn(nb_rows, nb_cols, generator=gen),
                              dim=1)
    return torch.cat(blocks, 0) * norms[:, None]


def softmax_kernel(x, projection, eps: float = 1e-4):
    """phi(x) = ratio * (exp(x P^T - |x|^2 / 2) + eps); x: (..., n, d)."""
    ratio = projection.shape[0] ** -0.5
    dash = torch.matmul(x, projection.T)
    diag = (x ** 2).sum(-1, keepdim=True) / 2.0
    return ratio * (torch.exp(dash - diag) + eps)


def linear_attention(q, k, v):
    k_sum = k.sum(dim=-2)
    d_inv = 1.0 / torch.matmul(q, k_sum.unsqueeze(-1))       # (..., n, 1)
    context = torch.matmul(k.transpose(-1, -2), v)           # (..., d, e)
    return torch.matmul(q, context) * d_inv


class ENLCA(nn.Module):
    def __init__(self, channels: int, reduction: int = 4,
                 res_scale: float = 0.1, nb_features: int = 128, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        rc = channels // reduction
        kw = dict(dtype=dtype, device=device)
        self.res_scale = res_scale
        self.conv_match1 = Conv(channels, rc, 1, **kw)
        self.conv_match2 = Conv(channels, rc, 1, **kw)
        self.conv_assembly = Conv(channels, channels, 1, **kw)
        gen = torch.Generator().manual_seed(PROJECTION_SEED)
        self.register_buffer('proj', gaussian_orthogonal_random_matrix(
            gen, nb_features, rc).to(device))

    def forward(self, x):
        b, c, h, w = x.shape
        kk = math.sqrt(6.0)

        def tokens(t):              # (B, C', H, W) -> (B, H*W, C')
            return t.flatten(2).transpose(1, 2)

        q = tokens(self.conv_match1(x))
        k = tokens(self.conv_match2(x))
        v = tokens(self.conv_assembly(x))
        q = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 2.5e-9) * kk
        k = k / torch.sqrt(torch.sum(k * k, -1, keepdim=True) + 2.5e-9) * kk
        proj = self.proj.to(q.dtype)
        out = linear_attention(softmax_kernel(q, proj),
                               softmax_kernel(k, proj), v)
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return out * self.res_scale + x


class ENLCN(FlaxNamed):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 n_resblocks: int = 32, n_feats: int = 256,
                 res_scale: float = 0.1, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_resblocks, self.dtype = n_resblocks, dtype
        self.add_module('head', Conv(in_chans, n_feats, 3, **kw))
        self.child('ENLCA', ENLCA(n_feats, 4, res_scale, **kw))
        for i in range(n_resblocks):
            self.child('ResBlock', ResBlock(n_feats, 3, res_scale, **kw))
            if (i + 1) % 8 == 0:
                self.child('ENLCA', ENLCA(n_feats, 4, res_scale, **kw))
        self.child('Conv', Conv(n_feats, n_feats, 3, **kw))
        self.child('Upsampler', Upsampler(upscale, n_feats, **kw))
        self.add_module('tail', Conv(n_feats, in_chans, 3, **kw))

    def reset_parameters(self, gen: torch.Generator):
        """The parameters; the ENLCA projections stay as drawn."""
        reset_all(self, gen)

    def forward(self, x):
        y = self.head(x)
        res = self.ENLCA_0(y)
        for i in range(self.n_resblocks):
            res = getattr(self, f'ResBlock_{i}')(res)
            if (i + 1) % 8 == 0:
                res = getattr(self, f'ENLCA_{(i + 1) // 8}')(res)
        y = y + self.Conv_0(res)
        return {'out': self.tail(self.Upsampler_0(y))}
