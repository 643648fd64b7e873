"""CSR-CNN multi-step noise augmenter (a copy of
srcaco2_tpu/data/augmenter.py; numpy on the host).

Reference analog: dataset_dpsr.Augment (dataset_dpsr.py:61-291) —
progressively upscale the LR toward the HR scale; at each step inject
noise whose per-intensity variance is matched to the HR's local patch
variance statistics (PatchMoments ksz 3, center-avg), optionally only
inside the ROI. NOTE: the reference disables it on the train path
("dropped for now", dataset_dpsr.py:858); provided for capability
parity and offline studies.
"""
from typing import Optional

import numpy as np

from srcaco2_tpu_torch.data.io import cv2_resize_cubic_uint8


def _local_stats(img: np.ndarray, ksz: int = 3):
    """Per-pixel (center value, unbiased variance of the ksz^2 window,
    reflect padded)."""
    pad = ksz // 2
    p = np.pad(img, pad, mode='reflect')
    windows = np.lib.stride_tricks.sliding_window_view(p, (ksz, ksz))
    flat = windows.reshape(img.shape[0], img.shape[1], -1)
    center = img
    var = flat.var(axis=-1, ddof=1)
    return center.ravel(), var.ravel()


class Augment:
    """Noise-matched progressive upscaling."""

    def __init__(self, upscale: int, nbr_steps: int, use_roi: bool,
                 color_min: int = 0, color_max: int = 255,
                 inter_low_th: float = 7.0, seed: int = 0):
        self.upscale = upscale
        self.nbr_steps = nbr_steps
        self.use_roi = use_roi
        self.color_min = color_min
        self.color_max = color_max
        self.th = inter_low_th
        self.rng = np.random.default_rng(seed)
        if nbr_steps == 1:
            self.scales = [1.0]
        else:
            self.scales = np.arange(1.0, nbr_steps,
                                    upscale / nbr_steps).tolist()
            self.scales.append(float(upscale))

    def add_noise(self, x_src: np.ndarray, x_trg: np.ndarray,
                  roi: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-intensity variance matching: for each uint8 color v in
        x_src, sample noise variances from the HR's local-variance
        distribution at pixels whose (rounded) intensity == v."""
        avg, vari = _local_stats(x_trg.astype(np.float64))
        avg_u8 = np.clip(np.round(avg), self.color_min,
                         self.color_max)
        src_u8 = np.clip(np.round(x_src), self.color_min,
                         self.color_max)
        out = x_src.astype(np.float64).copy()
        for v in np.unique(src_u8):
            v_var = vari[avg_u8 == v]
            if v_var.size == 0:
                continue
            uniq, counts = np.unique(v_var, return_counts=True)
            probs = (counts + 1.0) / (counts + 1.0).sum()
            sel = src_u8 == v
            n = int(sel.sum())
            chosen = self.rng.choice(uniq.size, size=n, p=probs)
            noise = self.rng.normal(0.0, np.sqrt(uniq[chosen]))
            if roi is not None:
                noise = noise * roi[sel]
            out[sel] += noise
        return out

    def perturbate(self, img_low: np.ndarray, img_high: np.ndarray,
                   roi: Optional[np.ndarray] = None) -> np.ndarray:
        """Progressively upscale img_low to img_high's size, injecting
        matched noise at every intermediate scale. Inputs HxW float
        [0,255]; returns the augmented bicubic-to-HR image."""
        h0, w0 = img_low.shape
        cur = img_low.astype(np.float64)
        for s in self.scales[1:] if len(self.scales) > 1 else []:
            size = (int(round(w0 * s)), int(round(h0 * s)))
            u8 = np.clip(np.round(cur), 0, 255).astype(np.uint8)
            cur = cv2_resize_cubic_uint8(u8[..., None],
                                         size)[..., 0].astype(np.float64)
            r = None
            if self.use_roi and roi is not None:
                r = (cur >= self.th).astype(np.float64).ravel().reshape(
                    cur.shape)
            trg_u8 = np.clip(np.round(img_high), 0, 255)
            trg_small = cv2_resize_cubic_uint8(
                trg_u8.astype(np.uint8)[..., None],
                size)[..., 0].astype(np.float64)
            cur = self.add_noise(cur, trg_small,
                                 r if self.use_roi else None)
            cur = np.clip(cur, self.color_min, self.color_max)
        # final: ensure HR size
        if cur.shape != img_high.shape:
            u8 = np.clip(np.round(cur), 0, 255).astype(np.uint8)
            cur = cv2_resize_cubic_uint8(
                u8[..., None], (img_high.shape[1], img_high.shape[0])
            )[..., 0].astype(np.float64)
        return np.clip(cur, self.color_min, self.color_max)
