"""DFCAN, deep Fourier channel attention network (port of
srcaco2_tpu/models/dfcan.py): 4 ResGroups x 4 RCABs of 64 channels; each
RCAB's channel attention reads the fftshifted |FFT|^0.8 of its features;
pixel-shuffle upsampling; sigmoid output. The FFT is torch.fft (cuFFT on
the card), in complex64 as JAX computes it. NCHW throughout."""
import torch
import torch.nn as nn

from srcaco2_tpu_torch.models.blocks import (Conv, FlaxNamed, pixel_shuffle,
                                             reset_all, stat_dtype)
from srcaco2_tpu_torch.models.swinir import _flax_gelu


def fftshift2d(x: torch.Tensor) -> torch.Tensor:
    """The quadrant swap of srcaco2_tpu/models/dfcan.py:fftshift2d on the
    last two axes: rows [h//2:, :h//2], columns [w//2:, :w//2]. For an
    odd size this is not torch.fft.fftshift (which rolls by n//2)."""
    h, w = x.shape[-2], x.shape[-1]
    x = torch.cat([x[..., h // 2:, :], x[..., :h // 2, :]], dim=-2)
    return torch.cat([x[..., w // 2:], x[..., :w // 2]], dim=-1)


def fourier_magnitude(y: torch.Tensor, gamma: float) -> torch.Tensor:
    """(|FFT_HW(y)| + 1e-8)^gamma in f32 from complex64 (stat_dtype),
    cast back to y's dtype, fftshifted."""
    sdt = stat_dtype(y.dtype)
    cdt = torch.complex128 if sdt == torch.float64 else torch.complex64
    f = torch.fft.fftn(y.to(sdt).to(cdt), dim=(-2, -1))
    f = torch.pow(torch.abs(f) + 1e-8, gamma).to(y.dtype)
    return fftshift2d(f)


class RCAB(nn.Module):
    def __init__(self, features: int = 64, gamma: float = 0.8, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gamma = gamma
        self.Conv_0 = Conv(features, features, 3, **kw)
        self.Conv_1 = Conv(features, features, 3, **kw)
        self.Conv_2 = Conv(features, features, 3, **kw)
        self.Conv_3 = Conv(features, 4, 1, **kw)
        self.Conv_4 = Conv(4, features, 1, **kw)

    def forward(self, x):
        y = _flax_gelu(self.Conv_0(x))
        y = _flax_gelu(self.Conv_1(y))
        f = torch.relu(self.Conv_2(fourier_magnitude(y, self.gamma)))
        f = f.mean(dim=(-2, -1), keepdim=True)          # global avg pool
        f = torch.relu(self.Conv_3(f))
        f = torch.sigmoid(self.Conv_4(f))
        return x + y * f


class ResGroup(FlaxNamed):
    def __init__(self, n_rcab: int = 4, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_rcab = n_rcab
        for _ in range(n_rcab):
            self.child('RCAB', RCAB(dtype=dtype, device=device))

    def forward(self, x):
        y = x
        for i in range(self.n_rcab):
            y = getattr(self, f'RCAB_{i}')(y)
        return x + y


class DFCAN(FlaxNamed):
    def __init__(self, in_chans: int = 1, upscale: int = 2,
                 n_resgroups: int = 4, *, dtype=torch.float32, device=None):
        super().__init__()
        self.upscale, self.n_resgroups = upscale, n_resgroups
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.child('Conv', Conv(in_chans, 64, 3, **kw))
        for _ in range(n_resgroups):
            self.child('ResGroup', ResGroup(n_rcab=n_resgroups, **kw))
        self.child('Conv', Conv(64, 64 * upscale ** 2, 3, **kw))
        self.child('Conv', Conv(64, in_chans, 3, **kw))

    def reset_parameters(self, gen: torch.Generator):
        reset_all(self, gen)

    def forward(self, x):
        y = _flax_gelu(self.Conv_0(x))
        for i in range(self.n_resgroups):
            y = getattr(self, f'ResGroup_{i}')(y)
        y = pixel_shuffle(_flax_gelu(self.Conv_1(y)), self.upscale)
        return {'out': torch.sigmoid(self.Conv_2(y))}
