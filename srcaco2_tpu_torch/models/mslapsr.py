"""MS-LapSRN, multi-scale deep Laplacian pyramid SR (port of
srcaco2_tpu/models/mslapsr.py): log2(scale) stages; each stage is 10
conv + leaky-ReLU layers and a x2 transposed conv on the feature path, a
one-channel x2 transposed conv on the image path (bilinear-filter init)
and a conv giving the stage residual. Every stage's prediction but the
last is returned under 'intermediate_outs' for the progressive loss.
NCHW; submodules carry the flax names."""
import torch

from srcaco2_tpu_torch.models.blocks import (ConvT, FlaxNamed,
                                             bilinear_upsample_init,
                                             reset_all, raw_conv)
from srcaco2_tpu_torch.ops.swin_block import _const


def _lrelu(x):
    """flax nn.leaky_relu(x, 0.2): where(x >= 0, x, 0.2 * x), the slope
    rounded to x's dtype as jnp rounds a weakly typed constant (bf16
    0.2001953125). F.leaky_relu multiplies by the f32 0.2, which rounds a
    tenth of bf16 outputs the other way."""
    return torch.where(x >= 0, x, x * _const(0.2, x.dtype))


def _up2(in_ch, out_ch, kw):
    return ConvT(in_ch, out_ch, 4, 2, 1, init=bilinear_upsample_init(4), **kw)


class _FeatStage(FlaxNamed):
    """10 conv + leaky-ReLU, then a x2 transposed conv + leaky-ReLU."""

    def __init__(self, features: int = 64, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        for _ in range(10):
            self.child('StridedConv', raw_conv(features, features, 3, **kw))
        self.child('ConvT', _up2(features, features, kw))

    def forward(self, x):
        for i in range(10):
            x = _lrelu(getattr(self, f'StridedConv_{i}')(x))
        return _lrelu(self.ConvT_0(x))


class MSLapSRN(FlaxNamed):
    def __init__(self, in_chans: int = 1, upscale: int = 2, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        assert upscale in (2, 4, 8), upscale
        self.levels = upscale.bit_length() - 1
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.child('StridedConv', raw_conv(in_chans, 64, 3, **kw))
        for lvl in range(1, self.levels + 1):
            self.add_module(f'img_up{lvl}', _up2(in_chans, in_chans, kw))
            self.add_module(f'feat_stage{lvl}', _FeatStage(**kw))
            self.add_module(f'res{lvl}', raw_conv(64, in_chans, 3, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        feat = _lrelu(self.StridedConv_0(x))
        img, outs = x, []
        for lvl in range(1, self.levels + 1):
            feat = getattr(self, f'feat_stage{lvl}')(feat)
            img = getattr(self, f'img_up{lvl}')(img) + \
                getattr(self, f'res{lvl}')(feat)
            outs.append(img)
        return {'out': outs[-1], 'intermediate_outs': outs[:-1]}
