"""CSR-CNN, constrained super-resolution CNN (port of
srcaco2_tpu/models/csrcnn.py): three variants behind one dispatcher,
each under its flax scope name:

  * 'unet' (default, `unet`): an encoder / decoder on the bicubic
    pre-upscaled input (k5 convs, two stride-2 encoders, decoders through
    ConvT(k3, s2, p1, output_padding=1)); for the segmentation net_task
    256 per-level logits (`raw_segmentation`), their softmax expectation
    (`expected_pred`), and `out` the expectation in training and
    argmax / color_max in evaluation;
  * 'pyramid' (`pyramid`): a x2 deconv net on the raw LR, with a
    bilinear `x_interp`;
  * 'snet_type*' (`smallcnn`): a small reflect-padded CNN with grouped
    1x1 layers, fed the pre-upscale (upscale 1).

Exposes x_interp / global_residual (and raw_segmentation, which the ce
loss reads). NCHW; submodules carry the flax names."""
import torch
import torch.nn as nn
import torch.nn.functional as F

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.models.blocks import (ConvT, FlaxNamed, bicubic_up,
                                             raw_conv, reset_all)
from srcaco2_tpu_torch.ops import resize as R


def _conv(in_ch, f, k, s=1, **kw):
    """The JAX module's _conv: a raw conv, padding (k - 1) // 2."""
    return raw_conv(in_ch, f, k, stride=s, padding=(k - 1) // 2, **kw)


class _Res5(nn.Module):
    """x + conv(relu(conv(x))), kernel k."""

    def __init__(self, f, k=5, **kw):
        super().__init__()
        self.StridedConv_0 = _conv(f, f, k, **kw)
        self.StridedConv_1 = _conv(f, f, k, **kw)

    def forward(self, x):
        return x + self.StridedConv_1(F.relu(self.StridedConv_0(x)))


def softmax_expectation(logits: torch.Tensor, color_max: int):
    """sum_c softmax(logits)_c * c / color_max over the class axis (1),
    rounded as jax.nn.softmax rounds in the compute dtype: the shifted
    exps rounded to it, their sum taken in f32 and rounded to it, the
    quotient rounded to it; the expectation in f32 (the compute dtype
    times the f32 level grid promotes). The shift by the max carries no
    gradient (jax.nn.softmax's stop_gradient)."""
    e = torch.exp(logits - logits.amax(1, keepdim=True).detach())
    p = e / e.float().sum(1, keepdim=True).to(e.dtype)
    colors = torch.arange(color_max + 1, dtype=torch.float32,
                          device=logits.device).reshape(1, -1, 1, 1)
    return (p * colors).sum(1, keepdim=True) / float(color_max)


class UNetSR(FlaxNamed):
    def __init__(self, upscale, in_channel, out_channel, outksz=3,
                 inner_channel=32, res_blocks=3, use_global_residual=True,
                 task=constants.REGRESSION, color_max=255, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        del upscale
        kw = dict(dtype=dtype, device=device)
        ic = inner_channel
        self.task, self.color_max = task, color_max
        self.use_global_residual = use_global_residual
        self.stacks = []

        def stack(c_in, f, n, k=5, stride=1):
            conv = self.child('StridedConv', _conv(c_in, f, k, stride, **kw))
            res = [self.child('_Res5', _Res5(f, k, **kw)) for _ in range(n)]
            self.stacks.append((conv, res))

        def res(f):
            return [self.child('_Res5', _Res5(f, **kw))
                    for _ in range(res_blocks)]

        stack(in_channel, ic, 3)            # feat
        stack(ic, ic, 3)                    # inb
        stack(ic, ic * 2, 3, stride=2)      # enc1
        stack(ic * 2, ic * 4, 3, stride=2)  # enc2
        self.dec2 = res(ic * 4)
        self.child('ConvT', ConvT(ic * 4, ic * 2, 3, 2, 1, 1, **kw))
        self.dec1 = res(ic * 2)
        self.child('ConvT', ConvT(ic * 2, ic, 3, 2, 1, 1, **kw))
        self.outb = res(ic)
        n_out = out_channel if task == constants.REGRESSION \
            else color_max + 1
        self.child('StridedConv', _conv(ic, n_out, outksz, **kw))

    def forward(self, x):
        y = x
        feats = []
        for conv, res in self.stacks:
            y = F.relu(conv(y))
            for r in res:
                y = r(y)
            feats.append(y)
        _, inb, enc1, dec2 = feats
        for r in self.dec2:
            dec2 = r(dec2)
        dec1 = F.relu(self.ConvT_0(dec2)) + enc1
        for r in self.dec1:
            dec1 = r(dec1)
        outb = F.relu(self.ConvT_1(dec1)) + inb
        for r in self.outb:
            outb = r(outb)
        out = self.StridedConv_4(outb)
        res = {'x_interp': x}
        if self.task == constants.REGRESSION:
            if self.use_global_residual:
                res['global_residual'] = out
                out = out + x
            res['out'] = out
            return res
        res['raw_segmentation'] = out
        expected = softmax_expectation(out, self.color_max)
        if self.training:
            res['out'] = expected
        else:
            res['out'] = torch.argmax(out, 1, keepdim=True) \
                / float(self.color_max)
        res['expected_pred'] = expected
        return res


class PyramidSR(FlaxNamed):
    """The x2 deconv net on the raw LR (only x2 supported upstream)."""

    def __init__(self, in_channel, out_channel, outksz=3, inner_channel=32,
                 res_blocks=3, use_global_residual=False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        ic = inner_channel
        self.use_global_residual = use_global_residual
        self.groups = []

        def group(c_in, f, k):
            conv = self.child('StridedConv', _conv(c_in, f, k, **kw))
            res = [self.child('_Res5', _Res5(f, 1, **kw))
                   for _ in range(res_blocks)]
            self.groups.append((conv, res))

        group(in_channel, ic, 3)
        group(ic, ic, 1)
        group(ic, ic * 2, 1)
        group(ic * 2, ic * 4, 1)
        self.n_before_up = len(self.groups)
        self.child('ConvT', ConvT(ic * 4, ic * 2, 3, 2, 1, 1, **kw))
        group(ic * 2, ic * 2, 3)
        group(ic * 2, ic * 2, 1)
        group(ic * 2, ic * 2, 1)
        group(ic * 2, ic * 4, 1)
        self.child('StridedConv', _conv(ic * 4, out_channel, outksz, **kw))

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        x_interp = R.resize2d(x, (h * 2, w * 2), method=R.BILINEAR)
        y = x
        for i, (conv, res) in enumerate(self.groups):
            if i == self.n_before_up:
                y = F.relu(self.ConvT_0(y))
            y = F.relu(conv(y))
            for r in res:
                y = r(y)
        out = self.StridedConv_8(y)
        res = {'x_interp': x_interp}
        if self.use_global_residual:
            res['global_residual'] = out
            out = out + x_interp
        res['out'] = out
        return res


class SmallCSRCNN(FlaxNamed):
    """Reflect-padded CNN with grouped 1x1 layers and an internal bicubic
    upscale (ConstrainedSupResCnn); Conv_<n> in flax's order (each
    layer's conv, then its residual projection where the width
    changes)."""

    def __init__(self, upscale, in_planes, h_layers, in_ksz=3, ngroups=16,
                 use_local_residual=False, use_global_residual=True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.local = upscale, use_local_residual
        self.use_global_residual = use_global_residual
        self.layers = []
        widths = list(h_layers) + [in_planes]
        c_in = in_planes
        for i, out_c in enumerate(widths):
            k = in_ksz if i == 0 else 1
            groups = ngroups if 0 < i < len(widths) - 1 else 1
            g = groups if c_in % groups == 0 and out_c % groups == 0 else 1
            conv = self.child('Conv', raw_conv(c_in, out_c, k, groups=g,
                                               pad_mode='reflect', **kw))
            proj = None
            if use_local_residual and c_in != out_c:
                proj = self.child('Conv', raw_conv(c_in, out_c, 1, groups=g,
                                                   **kw))
            act = (lambda v: v) if i == len(widths) - 1 else F.relu
            self.layers.append((conv, proj, act))
            c_in = out_c

    def forward(self, x):
        x_up = bicubic_up(x, self.upscale)
        h = x_up
        for conv, proj, act in self.layers:
            y = conv(h)
            if self.local:
                y = F.relu(y)
                y = y + (proj(h) if proj is not None else h)
            h = act(y)
        res = {'x_interp': x_up}
        if self.use_global_residual:
            res['global_residual'] = h
            h = h + x_up
        res['out'] = h
        return res


class CSRCNN(nn.Module):
    """The dispatcher (select_network.py's CSR-CNN branch)."""

    def __init__(self, in_planes: int = 1, upscale: int = 2,
                 net_type: str = constants.NET_TYPE_UNET, in_ksz: int = 3,
                 ngroups: int = 16, inner_channel: int = 32,
                 norm_groups: int = 16,
                 channel_mults: str = '1_2_4_8_16_32_32_32',
                 res_blocks: int = 3, dropout: float = 0.0,
                 use_global_residual: bool = True,
                 use_local_residual: bool = False,
                 net_task: str = constants.REGRESSION, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        # norm_groups, channel_mults and dropout are taken and ignored,
        # as the JAX module ignores them
        del norm_groups, channel_mults, dropout
        kw = dict(dtype=dtype, device=device)
        self.net_type, self.dtype = net_type, dtype
        if net_type == constants.NET_TYPE_UNET:
            self.unet = UNetSR(upscale, in_planes, in_planes, 3,
                               inner_channel, res_blocks,
                               use_global_residual, net_task, **kw)
        elif net_type == constants.NET_TYPE_PYRAMID:
            self.pyramid = PyramidSR(in_planes, in_planes, 3, inner_channel,
                                     res_blocks, use_global_residual, **kw)
        else:
            h_layers = tuple(constants.NETS_CNN.get(net_type, (32,)))
            # fed the bicubic pre-upscale like the unet variant, so no
            # internal upscale (upscale=1)
            self.smallcnn = SmallCSRCNN(1, in_planes, h_layers, in_ksz,
                                        ngroups, use_local_residual,
                                        use_global_residual, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        net = next(iter(self.children()))
        return net(x)
