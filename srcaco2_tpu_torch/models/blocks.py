"""Shared model building blocks (port of srcaco2_tpu/models/blocks.py).

The JAX package computes convolutions in NHWC; the port keeps PyTorch's
NCHW for them (cuDNN's layout) and holds parameters in PyTorch's
layouts: conv weights (O, I, kh, kw), transposed-conv weights (I, O,
kh, kw), dense weights in flax's (in, out). Parameters are f32; `dtype`
is the compute dtype that inputs and weights are cast to, as flax does.

Initializers are functions (weight, gen, fan_in, fan_out) drawing on the
CPU from a torch.Generator from the distribution of the flax initializer
of the same name; each module's `reset_parameters(gen)` draws its own
parameters only (`reset_all` walks a model). `FlaxNamed` gives a
module's children flax's auto-names, so that the port's state_dict
mirrors the flax param tree (bridge.flax_to_torch).
"""
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch.ops import resize as R

# flax's truncated normal: the standard normal cut at +-2, divided by its
# own standard deviation there (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_std_(p: torch.Tensor, std: float, gen: torch.Generator):
    with torch.no_grad():
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        p.copy_(t * (std / _TRUNC_STD))


def _uniform_(p: torch.Tensor, lo: float, hi: float,
              gen: torch.Generator):
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=gen) * (hi - lo) + lo)


def uniform_fan_in(p, gen, fan_in, fan_out):
    """variance_scaling(1, 'fan_in', 'uniform'): the blocks' `Conv` and
    `ConvT` default (torch's Conv2d family)."""
    del fan_out
    bound = math.sqrt(3.0 / fan_in)
    _uniform_(p, -bound, bound, gen)


def lecun_normal(p, gen, fan_in, fan_out):
    """variance_scaling(1, 'fan_in', 'truncated_normal'): flax's default
    for nn.Conv, nn.Dense and nn.ConvTranspose."""
    del fan_out
    _trunc_normal_std_(p, math.sqrt(1.0 / fan_in), gen)


def kaiming_fan_out(p, gen, fan_in, fan_out):
    """variance_scaling(2, 'fan_out', 'truncated_normal') (VDSR)."""
    del fan_in
    _trunc_normal_std_(p, math.sqrt(2.0 / fan_out), gen)


def normal(std: float):
    """nn.initializers.normal(stddev=std)."""
    def init(p, gen, fan_in, fan_out):
        del fan_in, fan_out
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return init


def bilinear_upsample_init(size: int):
    """The bilinear filter of srcaco2_tpu/models/blocks.py:
    bilinear_upsample_init (MSLapSRN's get_upsample_filter): every
    (in, out) channel pair gets the same 2D filter. The filter is
    symmetric, so the flip between the flax and the torch layouts of a
    transposed-conv kernel leaves it in place."""
    factor = (size + 1) // 2
    center = factor - 1 if size % 2 == 1 else factor - 0.5
    f1 = 1.0 - torch.abs(torch.arange(size, dtype=torch.float32)
                         - center) / factor
    filt = f1[:, None] * f1[None, :]

    def init(p, gen, fan_in, fan_out):
        del gen, fan_in, fan_out
        assert tuple(p.shape[-2:]) == (size, size), (p.shape, size)
        with torch.no_grad():
            p.copy_(filt.expand(p.shape))
    return init


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the flax modules take statistics in (LayerNorm, a
    softmax's sum, DFCAN's Fourier magnitude): f32 under a 16-bit or f32
    compute dtype. It follows a float64 compute dtype only for
    chip_smoke.py's zoo_check, which re-runs a training step with every
    module in float64 as its reference; training never does."""
    return torch.promote_types(dtype, torch.float32)


class _Conv2dF32(torch.autograd.Function):
    """F.conv2d in f32 on the card, its weight grad computed without
    cuDNN. With TF32 off, cuDNN's f32 weight grad of a 5x5 conv of 32
    channels at 128x128 (CSR-CNN's) lay 1.4e-3 from float64 in relative
    L2 (2.3e-5 of the terms' absolute sum), TF32's error, under its
    default, deterministic and benchmarked choices alike; PyTorch's own
    CUDA convolution (im2col and an f32 GEMM) lay 3e-7, the CPU's 8e-7
    (NVIDIA H100 80GB HBM3, 700 W). The forward and the input grad stay
    cuDNN's: within 1e-6 of float64 there."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf

        def grad(mask):
            return torch.ops.aten.convolution_backward(
                g, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False,
                [0, 0], groups, mask)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = grad([True, False, False])[0]
        if ctx.needs_input_grad[1]:
            with torch.backends.cudnn.flags(enabled=False):
                gw = grad([False, True, False])[1]
        return gx, gw, None, None, None


def _convolve(conv, x, w, dtype, **kw):
    """conv (F.conv2d or F.conv_transpose2d) of x and w cast to `dtype`.
    oneDNN's bf16 convolution on the CPU returns wrong values for some
    shapes (8x8 and 12x12 kernels over 8 input channels, PyTorch 2.13),
    in a convolution's forward and in a transposed one's backward: on the
    CPU a bf16 convolution runs as the f32 convolution of the bf16
    operands (exact products, f32 sums) rounded once, which is what a
    bf16 convolution computes, and its backward in f32 too. On the card
    an f32 conv2d that trains takes its weight grad from PyTorch's own
    CUDA convolution (_Conv2dF32)."""
    x, w = x.to(dtype), w.to(dtype)
    if x.device.type == 'cpu' and dtype == torch.bfloat16:
        return conv(x.float(), w.float(), **kw).to(dtype)
    if (conv is F.conv2d and x.is_cuda and dtype == torch.float32
            and torch.is_grad_enabled() and w.requires_grad):
        return _Conv2dF32.apply(x, w, kw['stride'], kw['padding'],
                                kw['groups'])
    return conv(x, w, **kw)


class Conv(nn.Module):
    """Square conv (flax nn.Conv with explicit symmetric padding, the
    blocks' `Conv` / `StridedConv` wrappers): stride, padding (default
    torch-like 'SAME', (k - 1) // 2), groups (feature_group_count) and an
    optional bias. NCHW in and out, in `dtype`. `init` defaults to the
    `Conv` wrapper's kernel init; a raw nn.Conv takes lecun_normal.
    `pad_mode` 'reflect' or 'replicate' pads the input so (jnp.pad's
    'reflect' and 'edge') and convolves it unpadded, as the zoo writes a
    reflect-padded conv (ProSR's RConv, DSR-Splines' and CSR-CNN's
    layers) and LIIF's edge-padded one."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *,
                 stride: int = 1, padding: int = None, groups: int = 1,
                 bias: bool = True, init=uniform_fan_in,
                 pad_mode: str = 'zeros', dtype=torch.float32, device=None):
        super().__init__()
        assert pad_mode in ('zeros', 'reflect', 'replicate'), pad_mode
        self.pad = (kernel - 1) // 2 if padding is None else padding
        self.stride, self.groups, self.init = stride, groups, init
        self.pad_mode, self.dtype = pad_mode, dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch // groups, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) \
            if bias else None

    def reset_parameters(self, gen: torch.Generator):
        """`init` over the kernel (fans as flax counts them from its
        (kh, kw, I/groups, O) kernel) and a zero bias."""
        o, i, kh, kw = self.weight.shape
        self.init(self.weight, gen, i * kh * kw, o * kh * kw)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        pad = self.pad
        if self.pad_mode != 'zeros' and pad:
            x, pad = F.pad(x, (pad,) * 4, mode=self.pad_mode), 0
        # flax's two rounding points: the convolution rounds to the
        # compute dtype, then the bias is added in that dtype
        y = _convolve(F.conv2d, x, self.weight, self.dtype,
                      stride=self.stride, padding=pad, groups=self.groups)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype)[:, None, None]


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NCHW: (B, C*r^2, H, W) -> (B, C, H*r, W*r) with
    input channel c*r^2 + dy*r + dx going to output channel c at offset
    (dy, dx), the order of srcaco2_tpu/models/blocks.py:pixel_shuffle
    (and of torch.nn.PixelShuffle)."""
    b, c, h, w = x.shape
    r = factor
    oc = c // (r * r)
    x = x.reshape(b, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, oc, h * r, w * r)


class Upsampler(nn.Module):
    """Pixel-shuffle upsampler: xN in factor-of-2 steps (or one x3)."""

    def __init__(self, scale: int, features: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if scale & (scale - 1) == 0:
            steps, mult, self.factor = scale.bit_length() - 1, 4, 2
        elif scale == 3:
            steps, mult, self.factor = 1, 9, 3
        else:
            raise NotImplementedError(scale)
        self.convs = nn.ModuleList(
            Conv(features, mult * features, 3, dtype=dtype, device=device)
            for _ in range(steps))

    def forward(self, x):
        for conv in self.convs:
            x = pixel_shuffle(conv(x), self.factor)
        return x


class UpsamplerDirect(nn.Module):
    """One conv straight to out_chans * scale^2, then pixel shuffle
    (SwinIR's 'pixelshuffledirect')."""

    def __init__(self, scale: int, in_ch: int, out_chans: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.scale = scale
        self.conv = Conv(in_ch, out_chans * scale ** 2, 3, dtype=dtype,
                         device=device)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.scale)


class ConvT(nn.Module):
    """The blocks' `ConvT` (torch ConvTranspose2d semantics): flax's
    nn.ConvTranspose(padding='VALID', transpose_kernel=False), then the
    crop of `padding` top / left and `padding - output_padding` bottom /
    right, which is torch's conv_transpose2d with that padding and
    output_padding. flax correlates the stride-dilated input with its
    (kh, kw, I, O) kernel as stored, torch's transposed convolution with
    the kernel flipped: the weight here is flax's kernel flipped in both
    spatial axes and laid out (I, O, kh, kw) (bridge.flax_to_torch does
    both)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 padding: int, output_padding: int = 0, *,
                 bias: bool = True, init=uniform_fan_in,
                 dtype=torch.float32, device=None):
        super().__init__()
        assert padding - output_padding >= 0, (padding, output_padding)
        self.stride, self.pad, self.out_pad = stride, padding, output_padding
        self.init, self.dtype = init, dtype
        self.weight = nn.Parameter(torch.empty(
            in_ch, out_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) \
            if bias else None

    def reset_parameters(self, gen: torch.Generator):
        i, o, kh, kw = self.weight.shape
        self.init(self.weight, gen, i * kh * kw, o * kh * kw)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = _convolve(F.conv_transpose2d, x, self.weight, self.dtype,
                      stride=self.stride, padding=self.pad,
                      output_padding=self.out_pad)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype)[:, None, None]


class Dense(nn.Module):
    """flax nn.Dense(dtype=dtype) with its default (lecun_normal) kernel
    init: input and weight cast to the compute dtype, the product in it,
    then the bias added in it. The weight keeps flax's (in, out) layout:
    y = x @ weight + bias."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, init=lecun_normal,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.init, self.dtype = init, dtype
        self.weight = nn.Parameter(torch.zeros(in_features, out_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) \
            if bias else None

    def reset_parameters(self, gen: torch.Generator):
        self.init(self.weight, gen, *self.weight.shape)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class PReLU(nn.Module):
    """flax nn.PReLU: one learned slope (init 0.01) for every channel."""

    def __init__(self, *, device=None):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((), 0.01,
                                                      device=device))

    def reset_parameters(self, gen: torch.Generator):
        del gen
        nn.init.constant_(self.negative_slope, 0.01)

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


class MeanShift(nn.Module):
    """Subtract / add a fixed channel mean scaled by img_range (EDSR-family
    preprocessing); NCHW."""

    def __init__(self, rgb_mean, sign: float = -1.0, img_range: float = 1.0):
        super().__init__()
        self.rgb_mean, self.sign, self.img_range = rgb_mean, sign, img_range

    def forward(self, x):
        mean = torch.as_tensor(self.rgb_mean, dtype=x.dtype,
                               device=x.device) * self.img_range
        return x + self.sign * mean[:, None, None]


def _bn_normalize(xs, mean, var, weight, bias, eps):
    """(x - mean) * (rsqrt(var + eps) * scale) + bias per channel of an
    NCHW x, in flax's order, in xs's dtype."""
    mul = torch.rsqrt(var + eps) * weight.to(xs.dtype)
    return (xs - mean[:, None, None]) * mul[:, None, None] \
        + bias.to(xs.dtype)[:, None, None]


class _BatchNormTrain(torch.autograd.Function):
    """BatchNorm over the batch statistics: forward as flax computes it
    (f32 statistics, the fast biased variance), and the exact gradient
    of that function in the backward, from the input and the per-channel
    mean and rsqrt only. Autograd over the forward's own ops would keep
    four f32 copies of every normalised map for the backward (51 GB for
    MemNet's step at batch 64 with its passes checkpointed)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        xs = x.to(stat_dtype(x.dtype))
        mean = xs.mean(dim=(0, 2, 3))
        var = torch.clamp((xs * xs).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        y = _bn_normalize(xs, mean, var, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, rstd = ctx.saved_tensors
        sd = stat_dtype(x.dtype)
        g = gy.to(sd)
        xhat = (x.to(sd) - mean[:, None, None]) * rstd[:, None, None]
        n = x.numel() // x.shape[1]
        dbias = g.sum(dim=(0, 2, 3))
        dweight = (g * xhat).sum(dim=(0, 2, 3))
        dx = (weight.to(sd) * rstd)[:, None, None] * (
            g - (dbias / n)[:, None, None]
            - xhat * (dweight / n)[:, None, None])
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(use_running_average=not train, momentum=0.9,
    epsilon=1e-5, dtype=dtype) over the channels of an NCHW input.

    In training the batch statistics are taken over (N, H, W) in f32
    (stat_dtype; flax's force_float32_reductions): the mean and flax's
    fast biased variance max(0, E[x^2] - E[x]^2), which normalise the
    input (_BatchNormTrain); then each running statistic moves as
    ra <- 0.9 ra + 0.1 batch (torch's `momentum` weighs the new value,
    and its running_var takes the unbiased variance: F.batch_norm is not
    this update). In evaluation the running statistics normalise. The
    output is (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
    rounded to `dtype`, in flax's order.

    The running statistics are persistent buffers under flax's names
    (`mean`, `var`, from its batch_stats collection), updated in place
    with copy_: the trainer holds the model's buffers once, and saves,
    evaluates and checkpoints through those tensors. `update_stats`
    off (set by the checkpointed passes' recompute, see
    `no_stat_updates`) normalises with the batch statistics as in
    training and leaves the running ones untouched: the recompute of a
    checkpointed forward must not move them a second time."""

    MOMENTUM = 0.9

    def __init__(self, features: int, *, eps: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer('mean', torch.zeros(features, device=device))
        self.register_buffer('var', torch.ones(features, device=device))

    def reset_parameters(self, gen: torch.Generator):
        del gen
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            sd = stat_dtype(x.dtype)
            return _bn_normalize(x.to(sd), self.mean.to(sd),
                                 self.var.to(sd), self.weight, self.bias,
                                 self.eps).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.eps, self.dtype)
        if self.update_stats:
            m = self.MOMENTUM
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return y


class no_stat_updates:
    """Context: every BatchNorm of `module` leaves its running statistics
    as they are (the recompute of a checkpointed forward)."""

    def __init__(self, module: nn.Module):
        self.bns = [m for m in module.modules() if isinstance(m, BatchNorm)]

    def __enter__(self):
        self.prev = [m.update_stats for m in self.bns]
        for m in self.bns:
            m.update_stats = False

    def __exit__(self, *exc):
        for m, p in zip(self.bns, self.prev):
            m.update_stats = p


def checkpointed(module: nn.Module, *args):
    """module(*args) under torch.utils.checkpoint (use_reentrant=False):
    its activations are recomputed in the backward instead of kept. The
    first run updates the module's BatchNorm statistics; the recompute
    does not (flax's remat drops the recompute's state changes, so the
    statistics move once per application, as without the checkpoint)."""
    from torch.utils.checkpoint import checkpoint
    runs = []

    def run(*a):
        if runs:
            with no_stat_updates(module):
                return module(*a)
        runs.append(1)
        return module(*a)

    return checkpoint(run, *args, use_reentrant=False)


class FlaxNamed(nn.Module):
    """A module whose children are registered under flax's auto-names:
    `<Class>_<n>`, one counter per class name in creation order (flax's
    `Conv` wrapper and a raw nn.Conv share the name "Conv"; a child flax
    names explicitly takes no number: add_module it). Build the children
    in the order the flax module creates them in its compact __call__
    (an outer call's module before the inner call's:
    `Conv(...)(relu(Conv(...)(y)))` names the outer Conv first)."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def child(self, kind: str, module: nn.Module) -> nn.Module:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        self.add_module(f'{kind}_{n}', module)
        return module


class ResBlock(nn.Module):
    """conv-relu-conv with residual scaling (EDSR-style), NCHW."""

    def __init__(self, features: int, kernel: int = 3,
                 res_scale: float = 1.0, bias: bool = True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(bias=bias, dtype=dtype, device=device)
        self.Conv_0 = Conv(features, features, kernel, **kw)
        self.Conv_1 = Conv(features, features, kernel, **kw)
        self.res_scale = res_scale

    def forward(self, x):
        h = self.Conv_1(F.relu(self.Conv_0(x)))
        return x + h * self.res_scale


class ConvReLU(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 bias: bool = True, *, dtype=torch.float32, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, bias=bias, dtype=dtype,
                           device=device)

    def forward(self, x):
        return F.relu(self.Conv_0(x))


def raw_conv(in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
             padding: int = None, groups: int = 1, bias: bool = True,
             pad_mode: str = 'zeros', dtype=torch.float32,
             device=None) -> Conv:
    """A raw flax nn.Conv (lecun_normal kernel) with symmetric padding,
    'SAME'-style by default: the blocks' `StridedConv` and the depthwise,
    strided and reflect-padded convs the zoo writes with nn.Conv."""
    return Conv(in_ch, out_ch, kernel, stride=stride, padding=padding,
                groups=groups, bias=bias, init=lecun_normal,
                pad_mode=pad_mode, dtype=dtype, device=device)


def bicubic_up(x: torch.Tensor, scale: int, clip: bool = True):
    """Internal bicubic pre-upsampling of VDSR / DRRN / MemNet (torch
    F.interpolate's bicubic, no antialias) on NCHW."""
    h, w = x.shape[-2], x.shape[-1]
    y = R.resize2d(x, (h * scale, w * scale))
    return torch.clip(y, 0.0, 1.0) if clip else y


def reset_all(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded init of every submodule that has parameters of its own, in
    module order."""
    for m in model.modules():
        if m is not model and hasattr(m, 'reset_parameters'):
            m.reset_parameters(gen)
    return model


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)
