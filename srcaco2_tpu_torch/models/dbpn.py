"""DBPN, deep back-projection network (port of srcaco2_tpu/models/dbpn.py,
the DBPN-RES-MR64-3 variant): feature extraction (3x3 -> feat, 1x1 ->
base_filter), a 7-up / 6-down dense back-projection chain run num_stages
times with the LR state carried from one stage to the next, the stages'
HR outputs concatenated before the last conv. Kernel, stride and padding
of the projections by scale: x2 (6, 2, 2), x4 (8, 4, 2), x8 (12, 8, 2).

`remat_blocks` (JAX's nn.remat of UpBlock / DownBlock, on by default)
runs each projection block under torch.utils.checkpoint in training:
the dense chain keeps every stage's HR maps alive, the checkpoint keeps
only the blocks' inputs. The flax param names do not change with it
(the blocks are named explicitly, `up1` ... `down6`), and neither do the
port's. NCHW; submodules carry the flax names."""
import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.blocks import (ConvT, PReLU, checkpointed,
                                             raw_conv, reset_all)

_KSP = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


class _CB(nn.Module):
    """Conv (explicit padding) + PReLU."""

    def __init__(self, in_ch, features, kernel=3, stride=1, padding=1, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.StridedConv_0 = raw_conv(in_ch, features, kernel,
                                      stride=stride, padding=padding,
                                      dtype=dtype, device=device)
        self.PReLU_0 = PReLU(device=device)

    def forward(self, x):
        return self.PReLU_0(self.StridedConv_0(x))


class _DB(nn.Module):
    """Transposed conv + PReLU."""

    def __init__(self, in_ch, features, kernel, stride, padding, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ConvT_0 = ConvT(in_ch, features, kernel, stride, padding,
                             dtype=dtype, device=device)
        self.PReLU_0 = PReLU(device=device)

    def forward(self, x):
        return self.PReLU_0(self.ConvT_0(x))


class UpBlock(nn.Module):
    """LR -> HR projection: h0 = up(x), l0 = down(h0), h1 = up(l0 - x),
    h1 + h0; with `compress` > 0, x is first a 1x1 conv of
    compress * nf channels."""

    def __init__(self, nf, k, s, p, compress=0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compress = compress
        # flax's names: _CB_0 is the compression when there is one
        n = 0
        if compress:
            self._CB_0 = _CB(compress * nf, nf, 1, 1, 0, **kw)
            n = 1
        self._DB_0 = _DB(nf, nf, k, s, p, **kw)
        self.add_module(f'_CB_{n}', _CB(nf, nf, k, s, p, **kw))
        self._DB_1 = _DB(nf, nf, k, s, p, **kw)

    def forward(self, x):
        n = 0
        if self.compress:
            x = self._CB_0(x)
            n = 1
        h0 = self._DB_0(x)
        l0 = getattr(self, f'_CB_{n}')(h0)
        h1 = self._DB_1(l0 - x)
        return h1 + h0


class DownBlock(nn.Module):
    """HR -> LR projection: l0 = down(x), h0 = up(l0), l1 = down(h0 - x),
    l1 + l0; with `compress` > 0, x is first a 1x1 conv of
    compress * nf channels."""

    def __init__(self, nf, k, s, p, compress=0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compress = compress
        n = 0
        if compress:
            self._CB_0 = _CB(compress * nf, nf, 1, 1, 0, **kw)
            n = 1
        self.add_module(f'_CB_{n}', _CB(nf, nf, k, s, p, **kw))
        self._DB_0 = _DB(nf, nf, k, s, p, **kw)
        self.add_module(f'_CB_{n + 1}', _CB(nf, nf, k, s, p, **kw))

    def forward(self, x):
        n = 0
        if self.compress:
            x = self._CB_0(x)
            n = 1
        l0 = getattr(self, f'_CB_{n}')(x)
        h0 = self._DB_0(l0)
        l1 = getattr(self, f'_CB_{n + 1}')(h0 - x)
        return l1 + l0


class DBPN(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 base_filter: int = 64, feat: int = 256,
                 num_stages: int = 3, remat_blocks: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        k, s, p = _KSP[upscale]
        nf = base_filter
        kw = dict(dtype=dtype, device=device)
        self.num_stages, self.remat_blocks, self.dtype = (
            num_stages, remat_blocks, dtype)
        self._CB_0 = _CB(in_chans, feat, 3, 1, 1, **kw)
        self._CB_1 = _CB(feat, nf, 1, 1, 0, **kw)
        # up1, down1, up2 take nf channels; down2 ... up7 the dense
        # concatenation of 2 ... 6 earlier maps
        self.up1 = UpBlock(nf, k, s, p, **kw)
        self.down1 = DownBlock(nf, k, s, p, **kw)
        self.up2 = UpBlock(nf, k, s, p, **kw)
        for i in range(2, 7):
            self.add_module(f'down{i}', DownBlock(nf, k, s, p, i, **kw))
            self.add_module(f'up{i + 1}', UpBlock(nf, k, s, p, i, **kw))
        self.StridedConv_0 = raw_conv(num_stages * nf, in_chans, 3,
                                      padding=1, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        remat = self.remat_blocks and self.training and \
            torch.is_grad_enabled()

        def run(name, z):
            block = getattr(self, name)
            return checkpointed(block, z) if remat else block(z)

        l = self._CB_1(self._CB_0(x))
        results = []
        for _ in range(self.num_stages):
            h1 = run('up1', l)
            l1 = run('down1', h1)
            h2 = run('up2', l1)
            concat_h = torch.cat([h2, h1], 1)
            l = run('down2', concat_h)
            concat_l = torch.cat([l, l1], 1)
            h = run('up3', concat_l)
            for i in range(3, 7):
                concat_h = torch.cat([h, concat_h], 1)
                l = run(f'down{i}', concat_h)
                concat_l = torch.cat([l, concat_l], 1)
                h = run(f'up{i + 1}', concat_l)
            results.append(h)
        return {'out': self.StridedConv_0(torch.cat(results, 1))}
