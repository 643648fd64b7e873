"""Pre-upsampling CNNs (port of srcaco2_tpu/models/cnn_pre.py): SRCNN,
VDSR, DRRN and MemNet. Each returns the JAX module's dict: 'out' (NCHW),
and for the last three 'x_interp' / 'global_residual', which the
`use_residuals` loss terms read. Submodules carry flax's auto-names
(Conv_0, ...); MemNet's BatchNorms keep flax's running statistics as
buffers (blocks.BatchNorm)."""
import math

import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.models.blocks import (BatchNorm, Conv, FlaxNamed,
                                             bicubic_up, checkpointed,
                                             kaiming_fan_out, lecun_normal,
                                             normal, reset_all)


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


class DRRN(FlaxNamed):
    """Deep recursive residual network over the internal bicubic
    pre-upscale: a bias-free 3x3 conv, then one recursive unit (the
    shared `rec1` / `rec2` convs, pre-activation) applied
    num_residual_units times, each time added to the shortcut relu(h0),
    not h0 (the reference's in-place ReLU; srcaco2_tpu/models/
    cnn_pre.py:95-100), then a 3x3 conv to the channels. Every conv is
    bias-free with variance_scaling(2, 'fan_out', truncated normal)."""

    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 num_residual_units: int = 25, features: int = 128, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.upscale, self.units, self.dtype = upscale, num_residual_units, \
            dtype
        kw = dict(bias=False, init=kaiming_fan_out, dtype=dtype,
                  device=device)
        self.child('Conv', Conv(in_chans, features, 3, **kw))
        self.rec1 = Conv(features, features, 3, **kw)
        self.rec2 = Conv(features, features, 3, **kw)
        self.child('Conv', Conv(features, in_chans, 3, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        x_up = bicubic_up(x, self.upscale)
        shortcut = F.relu(self.Conv_0(F.relu(x_up)))
        h = shortcut
        for _ in range(self.units):
            z = self.rec2(F.relu(self.rec1(F.relu(h))))
            h = shortcut + z
        res = self.Conv_1(F.relu(h))
        return {'out': x_up + res, 'x_interp': x_up,
                'global_residual': res}


class _MemResidualBlock(FlaxNamed):
    """Pre-activation residual block: BN-ReLU-conv-BN-ReLU-conv plus the
    identity, bias-free convs."""

    def __init__(self, features: int, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        cw = dict(bias=False, **kw)
        self.child('BatchNorm', BatchNorm(features, **kw))
        self.child('Conv', Conv(features, features, 3, **cw))
        self.child('BatchNorm', BatchNorm(features, **kw))
        self.child('Conv', Conv(features, features, 3, **cw))

    def forward(self, x):
        h = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        h = self.Conv_1(F.relu(self.BatchNorm_1(h)))
        return x + h


class _MemChain(FlaxNamed):
    """One pass over a memory block's R distinct residual blocks."""

    def __init__(self, features: int, num_resblocks: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        for _ in range(num_resblocks):
            self.child('_MemResidualBlock', _MemResidualBlock(
                features, dtype=dtype, device=device))

    def forward(self, x):
        for blk in self.children():
            x = blk(x)
        return x


class _MemoryBlock(FlaxNamed):
    """A memory block: the state pushed through the same R-block chain R
    times (R^2 applications of shared weights, the reference's
    recursion), each pass's output kept; the passes' outputs and the
    long-term memories concatenated, then a BN-ReLU-1x1 gate (a raw
    bias-free conv). `remat_passes` checkpoints each chain pass in
    training (checkpointed: the BatchNorm statistics still move once
    per application)."""

    def __init__(self, features: int, num_resblocks: int, n_memories: int,
                 remat_passes: bool = True, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_resblocks, self.remat_passes = num_resblocks, remat_passes
        self.child('_MemChain', _MemChain(features, num_resblocks, **kw))
        gate_in = features * (num_resblocks + n_memories)
        self.child('BatchNorm', BatchNorm(gate_in, **kw))
        self.child('Conv', Conv(gate_in, features, 1, bias=False,
                                init=lecun_normal, **kw))

    def forward(self, x, long_term):
        chain = self._MemChain_0
        remat = self.remat_passes and self.training and \
            torch.is_grad_enabled()
        outs, h = [], x
        for _ in range(self.num_resblocks):
            h = checkpointed(chain, h) if remat else chain(h)
            outs.append(h)
        g = self.BatchNorm_0(torch.cat(outs + long_term, 1))
        return self.Conv_0(F.relu(g))


class MemNet(FlaxNamed):
    """Memory network, BN variant, over the internal bicubic pre-upscale:
    an input BN-ReLU-conv, num_memory_blocks memory blocks each gating
    over all earlier memories, an output BN-ReLU-1x1 conv; returns
    x_up + res. The running statistics of every BatchNorm update in
    training (model.train()) and normalise in evaluation."""

    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 num_memory_blocks: int = 6, num_residual_blocks: int = 6,
                 features: int = 64, remat_passes: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.dtype = upscale, dtype
        self.n_mem = num_memory_blocks
        self.child('BatchNorm', BatchNorm(in_chans, **kw))
        self.child('Conv', Conv(in_chans, features, 3, bias=False, **kw))
        for i in range(num_memory_blocks):
            self.add_module(f'memblock{i}', _MemoryBlock(
                features, num_residual_blocks, i + 1, remat_passes, **kw))
        self.child('BatchNorm', BatchNorm(features, **kw))
        self.child('Conv', Conv(features, in_chans, 1, bias=False,
                                init=lecun_normal, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        x_up = bicubic_up(x, self.upscale)
        feat = self.Conv_0(F.relu(self.BatchNorm_0(x_up)))
        long_term, h = [feat], feat
        for i in range(self.n_mem):
            h = getattr(self, f'memblock{i}')(h, long_term)
            long_term.append(h)
        res = self.Conv_1(F.relu(self.BatchNorm_1(h)))
        return {'out': x_up + res, 'x_interp': x_up,
                'global_residual': res}
