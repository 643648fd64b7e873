"""Pre-upsampling CNNs (port of srcaco2_tpu/models/cnn_pre.py): SRCNN and
VDSR. Each returns the JAX module's dict: 'out' (NCHW), and for VDSR
'x_interp' / 'global_residual', which the `use_residuals` loss terms
read. Submodules carry flax's auto-names (Conv_0, ...)."""
import math

import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (Conv, FlaxNamed, bicubic_up,
                                             kaiming_fan_out, normal,
                                             reset_all)


class SRCNN(FlaxNamed):
    """3-layer mapping CNN on the bicubically pre-upscaled input: conv
    5x5 / 1024, conv 1x1 / 128, conv 1x1 / C, ReLU between; Gaussian
    kernel inits."""

    def __init__(self, in_chans: int = 1, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.child('Conv', Conv(in_chans, 1024, 5, init=normal(
            math.sqrt(2 / (1024 * 25))), **kw))
        self.child('Conv', Conv(1024, 128, 1, init=normal(
            math.sqrt(2 / 128)), **kw))
        self.child('Conv', Conv(128, in_chans, 1, init=normal(1e-3), **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        y = F.relu(self.Conv_0(x))
        y = F.relu(self.Conv_1(y))
        return {'out': self.Conv_2(y)}


class VDSR(FlaxNamed):
    """20 bias-free 3x3 convs (64 features, ReLU) over the internal
    bicubic pre-upscale, plus that pre-upscale."""

    def __init__(self, in_chans: int = 1, upscale: int = 2, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.upscale, self.dtype = upscale, dtype
        kw = dict(bias=False, init=kaiming_fan_out, dtype=dtype,
                  device=device)
        chans = [in_chans] + [64] * 19 + [in_chans]
        for i in range(20):
            self.child('Conv', Conv(chans[i], chans[i + 1], 3, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        x_up = bicubic_up(x, self.upscale)
        y = x_up
        for i in range(19):
            y = F.relu(getattr(self, f'Conv_{i}')(y))
        res = self.Conv_19(y)
        return {'out': x_up + res, 'x_interp': x_up,
                'global_residual': res}
