"""Evaluation metrics with the reference's quirks (port of
srcaco2_tpu/ops/metrics.py).

  * metrics on uint8-rounded float images in [0, 255];
  * a `border=scale` crop before everything;
  * an MSE floor: below MSE_FLOOR the PSNR is the reference's cap of
    496.6655 dB (its float32(1e-45) floor), for identical images;
  * ROI = (H >= th) binary mask; masked sums divided by the ROI size,
    an empty ROI counted as 1;
  * NRMSE's denominator with the ROI-aware min max(min_all, min_roi), a
    zero denominator taken as 1;
  * SSIM with an 11-tap Gaussian (sigma 1.5), a *valid* convolution (no
    padding), data range 255, k1=0.01, k2=0.03, the ROI cropped by the
    convolution margin;
  * ROI metrics marginalized over thresholds 4..10 (constants.ROI_THRESH);
  * PSNR-Y: grayscale repeated to 3 channels, MATLAB rgb2ycbcr's Y.

Every function takes NCHW float tensors in [0, 255] and returns per-sample
(B,) vectors. Sums are f32 (squared differences of integers <= 255 are
exact); the SSIM filter runs as two banded f32 matrix products (the
caller keeps TF32 off on the card, the default for matmuls).
"""
import functools

import numpy as np
import torch

from srcaco2_tpu_torch import constants

MSE_FLOOR = 1e-37            # a normal f32; any real uint8 mismatch gives
                             # mse >= ~4e-6
PSNR_CAP_DB = 496.6655


def uint8_round(x: torch.Tensor) -> torch.Tensor:
    """clamp(0, 1) -> *255 -> round: the uint8 quantization of both
    prediction and target before the metrics."""
    return torch.clip(torch.round(torch.clip(x, 0.0, 1.0) * 255.0), 0.0,
                      255.0)


def _crop_border(x: torch.Tensor, border: int) -> torch.Tensor:
    if border == 0:
        return x
    return x[..., border:-border, border:-border]


def rgb2ycbcr(img: torch.Tensor, only_y: bool = True) -> torch.Tensor:
    """MATLAB rgb2ycbcr on NCHW float input in [0, 1]."""
    x = img.float() * 255.0
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = (65.481 * r + 128.553 * g + 24.966 * b) / 255.0 + 16.0
    if only_y:
        return (y / 255.0)[:, None]
    cb = (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0 + 128.0
    cr = (112.0 * r - 93.786 * g - 18.214 * b) / 255.0 + 128.0
    return torch.stack([y, cb, cr], dim=1) / 255.0


def _to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Repeat 1 channel to 3 for the Y-channel metrics."""
    if x.shape[1] == 1:
        return x.repeat(1, 3, 1, 1)
    if x.shape[1] != 3:
        raise ValueError(f'expected 1 or 3 channels, got {x.shape}')
    return x


def _masked_mse(img1, img2, roi):
    b = img1.shape[0]
    diff = (img1 - img2).float()
    if roi is None:
        return (diff.reshape(b, -1) ** 2).mean(-1)
    roi = roi.float()
    diff = diff * roi
    tt = roi.reshape(b, -1).sum(-1)
    tt = torch.where(tt == 0, torch.ones_like(tt), tt)
    return (diff.reshape(b, -1) ** 2).sum(-1) / tt


def _crop_all(img1, img2, roi, border):
    return (_crop_border(img1, border), _crop_border(img2, border),
            None if roi is None else _crop_border(roi, border))


def mb_psnr(img1: torch.Tensor, img2: torch.Tensor, border: int = 0,
            roi: torch.Tensor = None) -> torch.Tensor:
    mse = _masked_mse(*_crop_all(img1, img2, roi, border))
    psnr = 20.0 * torch.log10(255.0 / torch.sqrt(mse.clamp_min(MSE_FLOOR)))
    return torch.where(mse < MSE_FLOOR, torch.full_like(psnr, PSNR_CAP_DB),
                       psnr)


def mb_mse(img1: torch.Tensor, img2: torch.Tensor, border: int = 0,
           roi: torch.Tensor = None) -> torch.Tensor:
    return _masked_mse(*_crop_all(img1, img2, roi, border))


def mb_nrmse(img: torch.Tensor, y: torch.Tensor, border: int = 0,
             roi: torch.Tensor = None) -> torch.Tensor:
    img, y, roi = _crop_all(img, y, roi, border)
    b = img.shape[0]
    mse = _masked_mse(img, y, roi)
    if roi is None:
        _y = y.reshape(b, -1)
        _min = _y.amin(-1)
    else:
        _min_all = y.reshape(b, -1).amin(-1)
        _y = (y * roi.to(y.dtype)).reshape(b, -1)
        _min = torch.maximum(_min_all, _y.amin(-1))
    denom = _y.amax(-1) - _min
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.sqrt(mse) / denom


@functools.lru_cache(maxsize=16)
def _gaussian_kernel2d(size: int, sigma: float) -> np.ndarray:
    """2D kernel exp(-(gx + gy) / 2s^2), normalized jointly (the
    reference's _gaussian_filter)."""
    coords = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    k = g[None, :] * g[:, None]
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _valid_band(n: int, kernel1d: tuple) -> np.ndarray:
    """(n-k+1, n) banded matrix applying a VALID 1D correlation."""
    k = np.asarray(kernel1d, np.float64)
    out = n - len(k) + 1
    m = np.zeros((out, n), np.float32)
    for i in range(out):
        m[i, i:i + len(k)] = k
    return m


@functools.lru_cache(maxsize=64)
def _band_on(n: int, kernel1d: tuple, device: str) -> torch.Tensor:
    return torch.as_tensor(_valid_band(n, kernel1d)).to(device)


def _valid_depthwise_conv(x: torch.Tensor,
                          kernel2d: np.ndarray) -> torch.Tensor:
    """Depthwise VALID filtering of NCHW x with a separable 2D kernel,
    as two banded f32 matrix products."""
    u, s, vt = np.linalg.svd(kernel2d)
    kv = (u[:, 0] * np.sqrt(s[0])).astype(np.float64)
    kh = (vt[0] * np.sqrt(s[0])).astype(np.float64)
    if kv.sum() < 0:
        kv, kh = -kv, -kh
    dev = str(x.device)
    mh = _band_on(x.shape[2], tuple(kv), dev)
    mw = _band_on(x.shape[3], tuple(kh), dev)
    y = torch.einsum('oh,bchw->bcow', mh, x)
    return torch.einsum('ow,bchw->bcho', mw, y)


def mb_ssim(x: torch.Tensor, y: torch.Tensor, border: int = 0,
            roi: torch.Tensor = None, kernel_size: int = 11,
            kernel_sigma: float = 1.5) -> torch.Tensor:
    """SSIM on [0, 255] NCHW inputs, VALID convolution, ROI-aware."""
    data_range = 255.0
    k1, k2 = 0.01, 0.03
    x, y, roi = _crop_all(x.float(), y.float(), roi, border)
    x, y = x / data_range, y / data_range
    kern = _gaussian_kernel2d(kernel_size, kernel_sigma)
    c1, c2 = k1 ** 2, k2 ** 2
    mu_x = _valid_depthwise_conv(x, kern)
    mu_y = _valid_depthwise_conv(y, kern)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    # sigma via the shift identity conv((x-c)(y-c)) - (mu_x-c)(mu_y-c):
    # equal to conv(xy) - mu_x mu_y with less f32 cancellation
    cshift = 0.5
    xs, ys = x - cshift, y - cshift
    mxs, mys = mu_x - cshift, mu_y - cshift
    sigma_xx = _valid_depthwise_conv(xs * xs, kern) - mxs * mxs
    sigma_yy = _valid_depthwise_conv(ys * ys, kern) - mys * mys
    sigma_xy = _valid_depthwise_conv(xs * ys, kern) - mxs * mys
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ss = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    b, c = ss.shape[:2]
    if roi is None:
        ssim_val = ss.reshape(b, c, -1).mean(-1)
    else:
        pad = (kernel_size - 1) // 2
        roi_c = roi[:, :, pad:-pad, pad:-pad].float()
        tt = roi_c.reshape(b, -1).sum(-1)
        tt = torch.where(tt == 0, torch.ones_like(tt), tt)
        ssim_val = (ss * roi_c).reshape(b, c, -1).sum(-1) / tt[:, None]
    return ssim_val.mean(1)


def compute_metrics(e_img: torch.Tensor, h_img: torch.Tensor, border: int,
                    roi_th=None) -> dict:
    """One metric pass over a batch: e_img / h_img uint8-rounded [0, 255]
    NCHW. Returns per-sample (B,) tensors of psnr, psnr_y, mse, nrmse,
    ssim."""
    roi = None
    if roi_th is not None:
        roi = (h_img >= roi_th).float()[:, :1]
    e_y = rgb2ycbcr(_to_rgb(e_img) / 255.0, only_y=True) * 255.0
    h_y = rgb2ycbcr(_to_rgb(h_img) / 255.0, only_y=True) * 255.0
    return {
        constants.PSNR_MTR: mb_psnr(e_img, h_img, border, roi),
        constants.PSNR_Y_MTR: mb_psnr(e_y, h_y, border, roi),
        constants.MSE_MTR: mb_mse(e_img, h_img, border, roi),
        constants.NRMSE_MTR: mb_nrmse(e_img, h_img, border, roi),
        constants.SSIM_MTR: mb_ssim(e_img, h_img, border, roi),
    }


def compute_metrics_roi_marginal(e_img: torch.Tensor, h_img: torch.Tensor,
                                 border: int, ths=None) -> dict:
    """ROI metrics averaged over the thresholds `ths` (default
    constants.ROI_THRESH)."""
    ths = list(ths if ths is not None else constants.ROI_THRESH)
    acc = None
    for th in ths:
        m = compute_metrics(e_img, h_img, border, roi_th=float(th))
        acc = m if acc is None else {k: acc[k] + m[k] for k in acc}
    return {k: v / float(len(ths)) for k, v in acc.items()}
