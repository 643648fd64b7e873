"""SRFBN, super-resolution feedback network (port of
srcaco2_tpu/models/srfbn.py): LR features (3x3 -> 4F, 1x1 -> F, PReLU),
a FeedbackBlock (num_groups up / down projection pairs with dense 1x1
transitions; its hidden state fed back across steps) unrolled num_steps
times with shared weights; every step emits bilinear(x) + its
reconstruction, and all steps' outputs feed the curriculum loss.
`remat_steps` (JAX's nn.remat(FeedbackBlock)) runs each feedback step
under torch.utils.checkpoint in training: the step's activations are
recomputed in the backward, the same math with less memory.
Transposed-conv kernel, stride and padding by scale: x2 (6, 2, 2), x4
(8, 4, 2), x8 (12, 8, 2). NCHW; submodules carry the flax names."""
import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.blocks import (ConvT, PReLU, checkpointed,
                                             reset_all, raw_conv)
from srcaco2_tpu_torch.ops import resize as R

_KSP = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


class _CB(nn.Module):
    """Conv (torch-style padding, 'same' by default) + PReLU."""

    def __init__(self, in_ch, features, kernel=3, stride=1, padding=None,
                 act=True, *, dtype=torch.float32, device=None):
        super().__init__()
        p = padding if padding is not None else (kernel - 1) // 2
        self.StridedConv_0 = raw_conv(in_ch, features, kernel,
                                      stride=stride, padding=p, dtype=dtype,
                                      device=device)
        self.PReLU_0 = PReLU(device=device) if act else None

    def forward(self, x):
        y = self.StridedConv_0(x)
        return self.PReLU_0(y) if self.PReLU_0 is not None else y


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


class FeedbackBlock(nn.Module):
    def __init__(self, num_features: int, num_groups: int, upscale: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        k, s, p = _KSP[upscale]
        f = num_features
        kw = dict(dtype=dtype, device=device)
        self.num_groups = num_groups
        self.compress_in = _CB(2 * f, f, 1, **kw)
        for idx in range(num_groups):
            if idx > 0:
                self.add_module(f'uptran{idx}', _CB(f * (idx + 1), f, 1, **kw))
            self.add_module(f'up{idx}', _DB(f, f, k, s, p, **kw))
            if idx > 0:
                self.add_module(f'downtran{idx}',
                                _CB(f * (idx + 1), f, 1, **kw))
            self.add_module(f'down{idx}', _CB(f, f, k, s, p, **kw))
        self.compress_out = _CB(f * num_groups, f, 1, **kw)

    def forward(self, x, hidden):
        y = self.compress_in(torch.cat([x, hidden], 1))
        lr_feats, hr_feats = [y], []
        for idx in range(self.num_groups):
            ld_l = torch.cat(lr_feats, 1)
            if idx > 0:
                ld_l = getattr(self, f'uptran{idx}')(ld_l)
            hr_feats.append(getattr(self, f'up{idx}')(ld_l))
            ld_h = torch.cat(hr_feats, 1)
            if idx > 0:
                ld_h = getattr(self, f'downtran{idx}')(ld_h)
            lr_feats.append(getattr(self, f'down{idx}')(ld_h))
        return self.compress_out(torch.cat(lr_feats[1:], 1))


class SRFBN(nn.Module):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 num_features: int = 64, num_steps: int = 4,
                 num_groups: int = 6, remat_steps: bool = False, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        k, s, p = _KSP[upscale]
        f = num_features
        kw = dict(dtype=dtype, device=device)
        self.upscale, self.num_steps, self.dtype = upscale, num_steps, dtype
        self.remat_steps = remat_steps
        self.conv_in = _CB(in_chans, 4 * f, 3, **kw)
        self.feat_in = _CB(4 * f, f, 1, **kw)
        self.feedback = FeedbackBlock(f, num_groups, upscale, **kw)
        self.out = _DB(f, f, k, s, p, **kw)
        self.conv_out = _CB(f, in_chans, 3, act=False, **kw)

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        h, w = x.shape[-2], x.shape[-1]
        inter_res = R.resize2d(x, (h * self.upscale, w * self.upscale),
                               method=R.BILINEAR)
        y = self.feat_in(self.conv_in(x))
        hidden = y          # reset: the hidden state starts as the input
        outs = []
        remat = self.remat_steps and self.training and \
            torch.is_grad_enabled()
        for _ in range(self.num_steps):
            hidden = (checkpointed(self.feedback, y, hidden)
                      if remat else self.feedback(y, hidden))
            outs.append(inter_res + self.conv_out(self.out(hidden)))
        return {'out': outs[-1], 'intermediate_outs': outs}
