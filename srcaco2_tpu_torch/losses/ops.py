"""Differentiable loss operators (port of srcaco2_tpu/losses/ops.py):
derivatives, local statistics, soft histograms, KDE, and the train-time
SSIM as banded matrix products. All inputs NCHW.

The convolution operators (`image_gradient`, `laplacian_filter`,
`local_variation`, `patch_moments`) convolve with f32 kernels in true
f32 (TF32 off, JAX's Precision.HIGHEST) and, as JAX's
lax.conv_general_dilated, refuse an input of another dtype (a bf16
prediction) with a TypeError rather than cast it.
"""
import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from srcaco2_tpu_torch.data.transforms import reflect_pad


def conv_f32(x: torch.Tensor, kernels: np.ndarray) -> torch.Tensor:
    """VALID convolution of the f32 x (B,1,H,W) with the f32 kernels
    (K,1,k,k), TF32 off."""
    if x.dtype != torch.float32:
        raise TypeError(f'convolution of a {x.dtype} input with float32 '
                        f'kernels (the JAX operators refuse mixed dtypes)')
    w = torch.as_tensor(kernels, device=x.device)
    ctx = torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                     benchmark=False, deterministic=True,
                                     allow_tf32=False) \
        if x.is_cuda else contextlib.nullcontext()
    with ctx:
        return F.conv2d(x, w)


def _conv_replicate(x: torch.Tensor, kernels: np.ndarray,
                    pad: int) -> torch.Tensor:
    """x: (B,1,H,W); kernels: (K,1,k,k) -> (B,K,H,W), replicate (edge)
    padding."""
    return conv_f32(F.pad(x, (pad, pad, pad, pad), mode='replicate'),
                     kernels)


_GRAD_KERNELS = np.stack([
    np.array([[0, 0, 0], [-1, 0, 1], [0, 0, 0]], np.float32),
    np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32)])[:, None]
_LAPLACE_KERNEL = np.array([[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]],
                           np.float32)[None, None]


def image_gradient(x: torch.Tensor) -> torch.Tensor:
    """First-order derivative: 2-channel (horizontal, vertical) map."""
    return _conv_replicate(x, _GRAD_KERNELS, 1)


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """Second-order derivative (8-neighbor Laplacian)."""
    return _conv_replicate(x, _LAPLACE_KERNEL, 1)


@functools.lru_cache(maxsize=8)
def _locvar_kernels(ksz: int) -> np.ndarray:
    c = ksz // 2
    ks = []
    for i in range(ksz):
        for j in range(ksz):
            if i == c and j == c:
                continue
            k = np.zeros((ksz, ksz), np.float32)
            k[c, c] = 1.0
            k[i, j] = -1.0
            ks.append(k)
    return np.stack(ks)[:, None]


def local_variation(x: torch.Tensor, ksz: int = 3) -> torch.Tensor:
    """Center-minus-neighbor differences: (B, ksz^2-1, H, W)."""
    return _conv_replicate(x, _locvar_kernels(ksz), ksz // 2)


def patch_moments(x: torch.Tensor, ksz: int):
    """Per-pixel mean and unbiased variance over a ksz x ksz reflected
    window. x: (B,1,H,W) -> (avg, var) each (B, H*W)."""
    xp = reflect_pad(x, (ksz - 1) // 2)
    ones = np.ones((1, 1, ksz, ksz), np.float32)
    n = ksz * ksz
    mean = conv_f32(xp, ones) / n
    var = (conv_f32(xp * xp, ones) - n * mean * mean) / (n - 1)
    b = x.shape[0]
    return mean.reshape(b, -1), torch.clamp(var, min=0.0).reshape(b, -1)


def soft_histogram(x: torch.Tensor, bins: int = 256, vmin: float = 0.0,
                   vmax: float = 1.0, sigma: float = 1e5) -> torch.Tensor:
    """Differentiable histogram via sigmoid binning. x: (B, N) ->
    (B, bins), f32 (a bf16 x is promoted by the f32 centers)."""
    delta = (vmax - vmin) / bins
    centers = vmin + delta * (torch.arange(bins, dtype=torch.float32,
                                           device=x.device) + 0.5)
    d = x[:, None, :] - centers[None, :, None]
    h = torch.sigmoid(sigma * (d + delta / 2)) \
        - torch.sigmoid(sigma * (d - delta / 2))
    return h.sum(-1)


def _linspace(vmin: float, vmax: float, n: int, device) -> torch.Tensor:
    """jnp.linspace(vmin, vmax, n) in f32, bit for bit: vmin + i * step
    with the f32 step, the last point vmax."""
    step = torch.tensor((vmax - vmin) / (n - 1), dtype=torch.float32)
    out = vmin + torch.arange(n, dtype=torch.float32) * step
    out[-1] = vmax
    return out.to(device)


def gaussian_kde(x: torch.Tensor, nbins: int = 256,
                 bw: float = 1.0 / 255 ** 2, vmin: float = 0.0,
                 vmax: float = 1.0) -> torch.Tensor:
    """Gaussian KDE evaluated on a fixed grid. x: (B,C,H,W) -> (B, nbins),
    normalized to sum 1 per sample."""
    xf = x.reshape(x.shape[0], -1)
    centers = _linspace(vmin, vmax, nbins, x.device)
    d2 = (xf[:, None, :] - centers[None, :, None]) ** 2
    dens = torch.exp(-0.5 * d2 / bw).mean(-1)
    return dens / torch.clamp(dens.sum(-1, keepdim=True), min=1e-12)


def kl_2_gaussians(src_m, src_v, trg_m, trg_v, eps: float = 1.0):
    """KL(N(trg) || N(src)) per element."""
    sv = src_v + eps
    tv = trg_v + eps
    return (torch.log(torch.sqrt(sv) / torch.sqrt(tv))
            + (tv + (trg_m - src_m) ** 2) / (2.0 * sv) - 0.5)


def bhattacharyya(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, D) distributions -> (B,) BC coefficient."""
    return torch.sqrt(p * q).sum(1)


@functools.lru_cache(maxsize=32)
def _gauss_band(n: int, ws: int, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded matrix applying a zero-padded SAME 1D Gaussian
    window along one axis."""
    xs = np.arange(ws, dtype=np.float64) - ws // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    m = np.zeros((n, n), np.float32)
    half = ws // 2
    for i in range(n):
        for t in range(ws):
            j = i + t - half
            if 0 <= j < n:
                m[i, j] += g[t]
    return m


@functools.lru_cache(maxsize=32)
def _gauss_band_on(n: int, ws: int, device: str) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode:
    # the cache serves later autograd calls too
    with torch.inference_mode(False):
        return torch.as_tensor(_gauss_band(n, ws)).to(device)


def ssim_train(img1: torch.Tensor, img2: torch.Tensor,
               window_size: int = 11) -> torch.Tensor:
    """Train-time SSIM (zero-padded SAME Gaussian window, per-sample
    mean) of the reference's loss/ssim.py. Inputs (B,C,H,W) in [0,1];
    returns (B,). The separable Gaussian runs as two banded products; a
    bf16 image is promoted to the f32 band's dtype there, as jnp.einsum
    promotes it (the squares and products before it keep the inputs'
    promoted dtype, as in JAX)."""
    h, w_ = img1.shape[2], img1.shape[3]
    dev = str(img1.device)
    kh = _gauss_band_on(h, window_size, dev)
    kw = _gauss_band_on(w_, window_size, dev)

    def conv(x):
        dt = torch.promote_types(kh.dtype, x.dtype)
        y = torch.einsum('oh,bchw->bcow', kh.to(dt), x.to(dt))
        return torch.einsum('ow,bchw->bcho', kw.to(dt), y)

    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1s = mu1 * mu1
    mu2s = mu2 * mu2
    mu12 = mu1 * mu2
    s1 = conv(img1 * img1) - mu1s
    s2 = conv(img2 * img2) - mu2s
    s12 = conv(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1s + mu2s + c1)
                                              * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))
