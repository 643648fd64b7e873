"""ProSR, progressive dense pyramid SR network (port of
srcaco2_tpu/models/prosr.py, the ProSRL variant): one init conv; per
pyramid level (log2(upscale) of them) a 1x1 compression (levels > 0), a
chain of DenseResidualBlocks (a dense block, a 1x1 compression and a
res_factor residual), a final conv, the level's residual, a x2
pixel-shuffle upsampler (followed by a ReLU unless ps_woReLU) and a
reconstruction conv whose output, added to the clipped bicubic upscale
of the input, is the level's prediction. The last level's is `out`, the
others `intermediate_outs` (the progressive loss, train/steps.py).

Every 3x3 conv but the dense blocks' 1x1 is a reflect-padded raw conv
(`RConv`, lecun-normal init). max_num_feature and block_compression are
taken and ignored, as the JAX module ignores them. NCHW; submodules
carry the flax names."""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (Conv, FlaxNamed, bicubic_up,
                                             pixel_shuffle, raw_conv,
                                             reset_all)

# the JAX module's level_config when none is given
DEFAULT_LEVELS = {2: [[8] * 9], 4: [[8] * 9, [8] * 3],
                  8: [[8] * 9, [8] * 3, [8]]}


def _rconv(in_ch, out_ch, kernel=3, **kw):
    """RConv: a reflect-padded raw conv with a bias."""
    return raw_conv(in_ch, out_ch, kernel, pad_mode='reflect', **kw)


class DenseBlock(FlaxNamed):
    """num_layers of (1x1 conv to bn_size * growth, ReLU, reflect-padded
    3x3 conv to growth), each output concatenated to its input."""

    def __init__(self, in_ch, num_layers, growth_rate, bn_size, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_layers = num_layers
        for i in range(num_layers):
            c = in_ch + i * growth_rate
            self.child('Conv', Conv(c, bn_size * growth_rate, 1, **kw))
            self.child('RConv', _rconv(bn_size * growth_rate, growth_rate,
                                       **kw))

    def forward(self, x):
        for i in range(self.num_layers):
            y = getattr(self, f'RConv_{i}')(
                F.relu(getattr(self, f'Conv_{i}')(x)))
            x = torch.cat([x, y], 1)
        return x


class DenseResidualBlock(nn.Module):
    def __init__(self, num_layers, num_input_features, growth_rate,
                 bn_size, res_factor, *, dtype=torch.float32, device=None):
        super().__init__()
        self.res_factor = res_factor
        self.DenseBlock_0 = DenseBlock(num_input_features, num_layers,
                                       growth_rate, bn_size, dtype=dtype,
                                       device=device)
        self.Conv_0 = raw_conv(num_input_features + num_layers * growth_rate,
                               num_input_features, 1, bias=False,
                               dtype=dtype, device=device)

    def forward(self, x):
        y = self.Conv_0(self.DenseBlock_0(x))
        # JAX's `res_factor * y` takes the Python float in y's dtype
        # (weak typing): the factor is rounded to bf16 under amp
        f = torch.tensor(self.res_factor, dtype=torch.float32).to(y.dtype)
        return f * y + x


class ProSR(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 8,
                 num_init_features: int = 160, growth_rate: int = 40,
                 bn_size: int = 4, max_num_feature: int = 312,
                 level_config: dict = None, res_factor: float = 0.2,
                 block_compression: float = 0.4, ps_woReLU: bool = False,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        del max_num_feature, block_compression
        n = int(math.log2(upscale))
        # a config read back from JSON holds the levels under str keys
        levels = {int(k): v for k, v in
                  (level_config or DEFAULT_LEVELS).items()}
        cfg = levels[upscale]
        assert len(cfg) == n, (cfg, n)
        kw = dict(dtype=dtype, device=device)
        nf = num_init_features
        self.n_pyramids, self.cfg, self.ps_woReLU = n, cfg, ps_woReLU
        self.dtype = dtype
        self.add_module(f'init_conv_{n}', _rconv(in_chans, nf, **kw))
        for s in range(n):
            if s:
                self.add_module(f'compression_{s}',
                                raw_conv(nf, nf, 1, bias=False, **kw))
            for b, num_layers in enumerate(cfg[s]):
                self.add_module(f'p{s}_drb{b}', DenseResidualBlock(
                    num_layers, nf, growth_rate, bn_size, res_factor, **kw))
            self.add_module(f'p{s}_final_conv', _rconv(nf, nf, **kw))
            self.add_module(f'p{s}_up', _rconv(nf, 4 * nf, **kw))
            self.add_module(f'reconst_{s + 1}', _rconv(nf, in_chans, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        feats = getattr(self, f'init_conv_{self.n_pyramids}')(x)
        outs = []
        for s in range(self.n_pyramids):
            level_in = z = feats
            if s:
                z = getattr(self, f'compression_{s}')(z)
            for b in range(len(self.cfg[s])):
                z = getattr(self, f'p{s}_drb{b}')(z)
            feats = getattr(self, f'p{s}_final_conv')(z) + level_in
            feats = pixel_shuffle(getattr(self, f'p{s}_up')(feats), 2)
            if not self.ps_woReLU:
                feats = F.relu(feats)
            rec = getattr(self, f'reconst_{s + 1}')(feats)
            # bf16 + f32 promotes to f32, in both packages
            outs.append(rec + bicubic_up(x, 2 ** (s + 1)))
        return {'out': outs[-1], 'intermediate_outs': outs[:-1]}
