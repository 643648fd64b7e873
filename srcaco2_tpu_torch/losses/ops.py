"""Train-time SSIM as banded matrix products (port of
srcaco2_tpu/losses/ops.py:ssim_train and _gauss_band). The other loss
operators of that module are not ported yet (see ROADMAP.md)."""
import functools

import numpy as np
import torch


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
