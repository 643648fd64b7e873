"""Separable image resizing as two matrix products (port of
srcaco2_tpu/ops/resize.py).

The reference mixes three bicubic resizers: torch
``F.interpolate(mode='bicubic')`` (Keys a=-0.75, edge-clamped, optional
antialias), cv2 ``INTER_CUBIC`` (a=-0.75, no antialias) and MATLAB-style
``imresize`` (a=-0.5, antialias, reflect boundary). Every variant is a
linear map, separable by axis: the (out, in) weight matrix of each axis
is built once on the host (numpy, cached, the same code as the JAX
package) and applied as ``W_h @ img @ W_w^T`` in f32.
"""
import functools

import numpy as np
import torch

TORCH_BICUBIC = 'torch_bicubic'      # also matches cv2 INTER_CUBIC upscaling
MATLAB_BICUBIC = 'matlab_bicubic'
BILINEAR = 'bilinear'
NEAREST = 'nearest'


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with parameter `a`."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a,
                 0.0))


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


_KERNELS = {
    TORCH_BICUBIC: (lambda x: _cubic_kernel(x, -0.75), 4.0),
    MATLAB_BICUBIC: (lambda x: _cubic_kernel(x, -0.5), 4.0),
    BILINEAR: (_linear_kernel, 2.0),
}


@functools.lru_cache(maxsize=512)
def resize_weights(in_size: int, out_size: int, method: str = TORCH_BICUBIC,
                   antialias: bool = False,
                   align_corners: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) float32 resampling matrix for one axis.

    Half-pixel coordinates, src = (dst + 0.5) * in/out - 0.5 (torch with
    align_corners=False, MATLAB imresize), or dst * (in-1)/(out-1) with
    align_corners. Boundary: edge clamp for TORCH_BICUBIC/BILINEAR,
    reflect for MATLAB_BICUBIC. Antialias (downscaling only) widens the
    kernel by the ratio and renormalizes; torch's antialias path is
    Pillow's (a=-0.5, window truncated to the image)."""
    if method == NEAREST:
        w = np.zeros((out_size, in_size), dtype=np.float32)
        # torch 'nearest': src = floor(dst * in/out)
        idx = np.floor(np.arange(out_size) * (in_size / out_size))
        idx = np.clip(idx.astype(np.int64), 0, in_size - 1)
        w[np.arange(out_size), idx] = 1.0
        return w

    kernel_fn, support = _KERNELS[method]
    ratio = in_size / out_size

    if antialias and ratio > 1.0 and method in (TORCH_BICUBIC, BILINEAR):
        if method == TORCH_BICUBIC:
            kfn, supp = (lambda x: _cubic_kernel(x, -0.5)), 2.0
        else:
            kfn, supp = _linear_kernel, 1.0
        ss = ratio
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        for i in range(out_size):
            center = (i + 0.5) * ratio
            span = supp * ss
            xmin = max(0, int(center - span + 0.5))
            xmax = min(in_size, int(center + span + 0.5))
            xs = np.arange(xmin, xmax)
            w = kfn((xs + 0.5 - center) / ss)
            s = w.sum()
            if s != 0:
                w = w / s
            mat[i, xmin:xmax] = w
        return mat.astype(np.float32)

    scale = 1.0
    if antialias and ratio > 1.0:
        scale = ratio  # widen kernel when downscaling (MATLAB path).
    width = support * scale

    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * ratio - 0.5
    left = np.floor(src - width / 2.0 + 0.5).astype(np.int64)
    ntaps = int(np.ceil(width)) + 2
    taps = left[:, None] + np.arange(ntaps)[None, :]
    dist = src[:, None] - taps
    w = kernel_fn(dist / scale) / scale
    wsum = w.sum(axis=1, keepdims=True)
    wsum[wsum == 0] = 1.0
    w = w / wsum

    if method == MATLAB_BICUBIC:
        # reflect (symmetric) indexing: ... 1 0 | 0 1 2 ... n-1 | n-1 n-2 ...
        idx = taps.copy()
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= in_size, 2 * in_size - 1 - idx, idx)
        idx = np.clip(idx, 0, in_size - 1)
    else:
        idx = np.clip(taps, 0, in_size - 1)

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), ntaps), idx.ravel()),
              w.ravel())
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _weights_on(in_size, out_size, method, antialias, align_corners,
                dtype, device):
    """resize_weights as a tensor on `device`, copied there once; a
    normal tensor even when first asked for under inference_mode (an
    eval forward), since a resize inside a trained network (SRFBN,
    OmniSR's ESA) saves it for its backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(resize_weights(
            in_size, out_size, method, antialias, align_corners)
        ).to(device=device, dtype=dtype)


def resize2d(x: torch.Tensor, out_hw, method: str = TORCH_BICUBIC,
             antialias: bool = False,
             align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of `x` (..., H, W) -> (..., H', W') by
    two products with the per-axis weight matrices, in x's float dtype
    (f32 for integer inputs)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    dtype = x.dtype if x.is_floating_point() else torch.float32
    y = x.to(dtype)
    dev = str(x.device)
    if h_in != h_out:
        wh = _weights_on(h_in, h_out, method, antialias, align_corners,
                         dtype, dev)
        y = torch.einsum('oh,...hw->...ow', wh, y)
    if w_in != w_out:
        ww = _weights_on(w_in, w_out, method, antialias, align_corners,
                         dtype, dev)
        y = torch.einsum('ow,...hw->...ho', ww, y)
    return y


def interpolate(x: torch.Tensor, scale: float = None, size=None,
                mode: str = 'bicubic', antialias: bool = False
                ) -> torch.Tensor:
    """torch.nn.functional.interpolate's resampling over (..., H, W), as
    the JAX package computes it."""
    h, w = x.shape[-2], x.shape[-1]
    if size is None:
        size = (int(h * scale), int(w * scale))
    method = {'bicubic': TORCH_BICUBIC, 'bilinear': BILINEAR,
              'nearest': NEAREST}[mode]
    return resize2d(x, size, method=method, antialias=antialias)


def imresize_matlab(x: torch.Tensor, scale: float,
                    antialias: bool = True) -> torch.Tensor:
    """MATLAB-style imresize over (..., H, W) (reference analog:
    utils_image.imresize_np). Output size = ceil(in * scale)."""
    h, w = x.shape[-2], x.shape[-1]
    out = (int(np.ceil(h * scale)), int(np.ceil(w * scale)))
    return resize2d(x, out, method=MATLAB_BICUBIC, antialias=antialias)
