"""ACT, aggregated CNN-transformer network (port of
srcaco2_tpu/models/act.py): an RCAN-style CNN branch (ResidualGroups of
RCABs with channel attention) in parallel with a token branch (3x3-token
MHSA plus cross-scale attention between the 3x3 tokens and overlapping
6x6 tokens); n_fusionblocks fusion stages exchange the two through 1x1
fusion blocks, MLPs and conv refiners; pixel-shuffle tail.
Convolutions run on NCHW, the token branch on NHWC / (B, T, D) tokens
(ops/patches); submodules carry the flax names."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (Conv, Dense, FlaxNamed,
                                             Upsampler, reset_all, to_nchw,
                                             to_nhwc)
from srcaco2_tpu_torch.models.swinir import LayerNorm, _flax_gelu, _softmax
from srcaco2_tpu_torch.ops.patches import (fold_k2s, fold_nonoverlap,
                                           unfold_k2s, unfold_nonoverlap)
from srcaco2_tpu_torch.ops.swin_block import _const

LN_EPS = 1e-6       # flax nn.LayerNorm's default


class CALayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(channel, channel // reduction, 1, **kw)
        self.Conv_1 = Conv(channel // reduction, channel, 1, **kw)

    def forward(self, x):
        y = x.mean(dim=(-2, -1), keepdim=True)
        y = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(y))))
        return x * y


class RCAB(nn.Module):
    def __init__(self, n_feat: int, reduction: int = 16, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(n_feat, n_feat, 3, **kw)
        self.Conv_1 = Conv(n_feat, n_feat, 3, **kw)
        self.CALayer_0 = CALayer(n_feat, reduction, **kw)

    def forward(self, x):
        y = self.Conv_1(F.relu(self.Conv_0(x)))
        return x + self.CALayer_0(y)


class ResidualGroup(FlaxNamed):
    def __init__(self, n_feat: int, n_resblocks: int, reduction: int = 16,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_resblocks = n_resblocks
        for _ in range(n_resblocks):
            self.child('RCAB', RCAB(n_feat, reduction, **kw))
        self.child('Conv', Conv(n_feat, n_feat, 3, **kw))

    def forward(self, x):
        y = x
        for i in range(self.n_resblocks):
            y = getattr(self, f'RCAB_{i}')(y)
        return x + self.Conv_0(y)


def _attend(q, k, v, heads, dim_head):
    """Multi-head softmax attention of (B, N, H*D) q on (B, M, H*D) k, v
    in the compute dtype (jax.nn.softmax's rounding)."""
    b, n, _ = q.shape
    m = k.shape[1]
    q = q.reshape(b, n, heads, dim_head).transpose(1, 2)
    k = k.reshape(b, m, heads, dim_head).transpose(1, 2)
    v = v.reshape(b, m, heads, dim_head).transpose(1, 2)
    attn = _softmax(torch.matmul(q * _const(dim_head ** -0.5, q.dtype),
                                 k.transpose(-1, -2)))
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(b, n, heads * dim_head)


class SelfAttnBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, hidden: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.sa_qkv = Dense(dim, 3 * inner, bias=False, **kw)
        self.sa_out = Dense(inner, dim, **kw)
        self.LayerNorm_1 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.Dense_0 = Dense(dim, hidden, **kw)
        self.Dense_1 = Dense(hidden, dim, **kw)

    def forward(self, x):
        q, k, v = self.sa_qkv(self.LayerNorm_0(x)).chunk(3, dim=-1)
        x = self.sa_out(_attend(q, k, v, self.heads, self.dim_head)) + x
        y = self.Dense_1(_flax_gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + y


class CrossAttn(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.LayerNorm_0 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.LayerNorm_1 = LayerNorm(dim, eps=LN_EPS, **kw)
        self.Dense_0 = Dense(dim, inner, bias=False, **kw)
        self.Dense_1 = Dense(dim, 2 * inner, bias=False, **kw)
        self.Dense_2 = Dense(inner, dim, **kw)

    def forward(self, x_q, x_kv):
        q = self.Dense_0(self.LayerNorm_0(x_q))
        k, v = self.Dense_1(self.LayerNorm_1(x_kv)).chunk(2, dim=-1)
        return self.Dense_2(_attend(q, k, v, self.heads, self.dim_head))


def _mlp(parts, x):
    """LayerNorm, Dense, tanh-GELU, Dense: a token MLP of ACT's fusion
    stages (its modules are ACT's own children, under flax's names)."""
    ln, d0, d1 = parts
    return d1(_flax_gelu(d0(ln(x))))


class ACT(FlaxNamed):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 n_feats: int = 64, n_resgroups: int = 4,
                 n_resblocks: int = 12, reduction: int = 16,
                 n_heads: int = 8, n_layers: int = 8,
                 n_fusionblocks: int = 4, token_size: int = 3,
                 expansion_ratio: int = 4, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        del n_resgroups, n_layers       # unused by the forward, as in JAX
        ts, nf = token_size, n_feats
        emb = nf * ts * ts
        hidden = emb * expansion_ratio
        dim_head = emb // n_heads
        self.ts, self.n_fusionblocks, self.dtype = ts, n_fusionblocks, dtype
        kw = dict(dtype=dtype, device=device)

        def mlp(d_in, d_hidden, d_out):
            return (self.child('LayerNorm', LayerNorm(d_in, eps=LN_EPS,
                                                      **kw)),
                    self.child('Dense', Dense(d_in, d_hidden, **kw)),
                    self.child('Dense', Dense(d_hidden, d_out, **kw)))

        self.child('Conv', Conv(in_chans, nf, 3, **kw))
        for _ in range(2):
            self.child('Conv', Conv(nf, nf, 5, **kw))
            self.child('Conv', Conv(nf, nf, 5, **kw))
        self.add_module('linear_encoding', Dense(emb, emb, **kw))
        # per fusion stage: its token MLPs and conv refiner (modules
        # registered above under flax's names)
        self.stages = []
        for i in range(n_fusionblocks):
            st = {}
            self.add_module(f'mhsa{i}', SelfAttnBlock(emb, n_heads, dim_head,
                                                      hidden, **kw))
            st['big'] = mlp(emb * 2, emb // 2, emb // 2)
            for side in 'ab':
                self.add_module(f'cross_{side}{i}', CrossAttn(
                    emb // 2, n_heads // 2, dim_head, **kw))
            st['b2'] = mlp(emb // 2, emb // 2, emb * 2)
            st['z'] = mlp(emb, hidden, emb)
            self.add_module(f'rg{i}', ResidualGroup(nf, n_resblocks,
                                                    reduction, **kw))
            for j in range(4):
                for ab in 'ab':
                    self.add_module(f'fb{i}_{j}{ab}', Conv(
                        2 * nf, 2 * nf, 1, bias=False, **kw))
            if i != n_fusionblocks - 1:
                st['z2'] = mlp(emb, hidden, emb)
                # Conv(...)(relu(Conv(...)(y))): flax names the outer
                # (applied second) before the inner
                st['refine'] = (self.child('Conv', Conv(nf, nf, 3, **kw)),
                                self.child('Conv', Conv(nf, nf, 3, **kw)))
            self.stages.append(st)
        self.add_module('conv_last', Conv(2 * nf, nf, 3, **kw))
        self.child('Upsampler', Upsampler(upscale, nf, **kw))
        self.child('Conv', Conv(nf, in_chans, 3, **kw))
        self.tail_name = f"Conv_{self._counts['Conv'] - 1}"

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        ts = self.ts
        h, w = x.shape[-2], x.shape[-1]
        y = self.Conv_0(x)
        for c in (1, 3):
            r = F.relu(getattr(self, f'Conv_{c}')(y))
            y = y + getattr(self, f'Conv_{c + 1}')(r)
        identity = y

        tkn = unfold_nonoverlap(to_nhwc(y), ts)          # (B, T, emb)
        tkn = self.linear_encoding(tkn) + tkn
        f = None
        for i, st in enumerate(self.stages):
            tkn = getattr(self, f'mhsa{i}')(tkn)
            tkn_a, tkn_b = tkn.chunk(2, dim=-1)
            # large overlapping tokens from the b-half
            img_b = fold_nonoverlap(tkn_b, ts, (h, w))
            big = _mlp(st['big'], unfold_k2s(img_b, ts))  # (B, T2, emb/2)
            a2 = getattr(self, f'cross_a{i}')(tkn_a, big) + tkn_a
            b2 = getattr(self, f'cross_b{i}')(big, tkn_a) + big
            img_b2 = fold_k2s(_mlp(st['b2'], b2), ts, (h, w))   # overlap-add
            tkn = torch.cat([a2, unfold_nonoverlap(img_b2, ts)], dim=-1)
            tkn = tkn + _mlp(st['z'], tkn)

            # (the reference indexes cnn_branch[i], so its trailing conv
            # module never runs; JAX mirrors that, and so does the port)
            y = getattr(self, f'rg{i}')(y)
            tkn_res, y_res = tkn, y
            f = torch.cat([y, to_nchw(fold_nonoverlap(tkn, ts, (h, w)))],
                          dim=1)
            fb = f
            for j in range(4):
                r = F.relu(getattr(self, f'fb{i}_{j}a')(fb))
                fb = fb + getattr(self, f'fb{i}_{j}b')(r)
            f = f + fb

            if 'z2' in st:
                tkn_img2, y = f.chunk(2, dim=1)
                tkn = unfold_nonoverlap(to_nhwc(tkn_img2), ts)
                tkn = _mlp(st['z2'], tkn) + tkn_res
                outer, inner = st['refine']
                y = outer(F.relu(inner(y))) + y_res

        out = self.conv_last(f) + identity
        tail = getattr(self, self.tail_name)
        return {'out': tail(self.Upsampler_0(out))}
