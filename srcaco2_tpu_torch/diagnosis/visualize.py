"""Diagnosis figures (port of srcaco2_tpu/diagnosis/visualize.py), the
figure / GIF artifact classes of the reference's dlib/diagnosis +
dlib/visualization:

  * patch_sampling_demo  — ROI/EDT heatmaps + sampling-probability
    maps + drawn sample boxes (patches.py / demo_patches.py analog)
  * noise_model_plot     — metric-vs-noise curves + residual study
    (noise.py analog)
  * color_distribution   — per-cell intensity histograms/CDFs
    (color_dist analog)
  * restore_grid         — LR / bicubic / per-method / HR panels side by
    side, each captioned with its PSNR / SSIM against the HR, and an
    optional GIF that cycles the panels (restore.py /
    visualization/videos.py analog)

All figures are written headless (matplotlib Agg); GIFs via imageio.
matplotlib, imageio and cv2 are imported only when a figure is drawn;
where one is missing, the function raises an ImportError that names it
(the card's machine has no matplotlib). The captions need none of them.
"""
import importlib
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from srcaco2_tpu_torch.ops import metrics as M


def _require(module: str, purpose: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f'{purpose} needs {module}, which does not '
                          f'import here: {e}') from e


def has_matplotlib() -> bool:
    """Whether matplotlib imports here (the studies skip their figures
    where it does not)."""
    try:
        importlib.import_module('matplotlib')
    except ImportError:
        return False
    return True


def _plt(purpose: str):
    """matplotlib.pyplot on the Agg backend (an ImportError naming it
    where it is missing)."""
    matplotlib = _require('matplotlib', purpose)
    matplotlib.use('Agg')
    return _require('matplotlib.pyplot', purpose)


def _ensure_dir(path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


# ------------------------------------------------------------- sampling
def patch_sampling_demo(img_u8: np.ndarray, psize: int, out_path: str,
                        n_samples: int = 24, seed: int = 0) -> str:
    """One figure: image | ROI(otsu) | EDT heatmap | per-strategy
    sampling-probability maps | drawn sampled-patch boxes (reference
    dlib/diagnosis/patches.py + demo_patches.py)."""
    from srcaco2_tpu_torch import constants
    from srcaco2_tpu_torch.data.sampling import (edt_map, origin_prob_map,
                                                 otsu_threshold, roi_mask)
    plt = _plt('patch_sampling_demo')
    img = np.asarray(img_u8)
    if img.ndim == 3:
        img = img[..., 0]
    th = otsu_threshold(img)
    roi = roi_mask(img, constants.TH_AUTO, 0.0)
    edt = edt_map(roi)

    strategies = [constants.SAMPLE_UNIF, constants.SAMPLE_ROI,
                  constants.SAMPLE_EDT, constants.SAMPLE_EDTXROI]
    probs = {st: origin_prob_map(img, st, psize) for st in strategies}

    ncols = 3 + len(strategies)
    fig, axes = plt.subplots(1, ncols, figsize=(2.6 * ncols, 3.0))
    axes[0].imshow(img, cmap='magma')
    axes[0].set_title(f'image (otsu th={th:.0f})', fontsize=8)
    axes[1].imshow(roi, cmap='gray')
    axes[1].set_title('ROI mask', fontsize=8)
    axes[2].imshow(edt, cmap='viridis')
    axes[2].set_title('EDT', fontsize=8)
    for ax, st in zip(axes[3:], strategies):
        ax.imshow(probs[st], cmap='viridis')
        ax.set_title(f'p(origin) [{st}]', fontsize=8)
        # draw a few samples from this strategy
        rng = np.random.default_rng(seed)
        p = probs[st].ravel()
        p = p / p.sum()
        for k in rng.choice(p.size, size=min(n_samples, p.size),
                            p=p, replace=True):
            y, x = divmod(int(k), probs[st].shape[1])
            ax.add_patch(plt.Rectangle((x, y), psize, psize,
                                       fill=False, ec='w', lw=0.4))
    for ax in axes:
        ax.axis('off')
    fig.tight_layout()
    _ensure_dir(out_path)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------- noise
def noise_residual(hr_u8: np.ndarray, lr_u8: np.ndarray) -> Dict:
    """The real LR against the clean bicubic downscale of the HR (on the
    CPU, [0, 255]): {'clean', 'resid'} maps and the binned residual
    'centers' / 'stds' / 'means' over the clean intensity (18 edges over
    [0, 255], bins of more than 20 pixels) that noise_model_plot
    draws."""
    from srcaco2_tpu_torch.ops.resize import resize2d
    hr = np.asarray(hr_u8).astype(np.float32)
    lr = np.asarray(lr_u8).astype(np.float32)
    if hr.ndim == 3:
        hr = hr[..., 0]
    if lr.ndim == 3:
        lr = lr[..., 0]
    clean = resize2d(torch.from_numpy(hr)[None, None] / 255.0,
                     (lr.shape[0], lr.shape[1]))[0, 0].numpy() * 255.0
    resid = lr - clean
    bins = np.linspace(0, 255, 18)
    ctr, stds, means = [], [], []
    for a, b in zip(bins[:-1], bins[1:]):
        m = (clean >= a) & (clean < b)
        if m.sum() > 20:
            ctr.append(0.5 * (a + b))
            stds.append(resid[m].std())
            means.append(resid[m].mean())
    return {'lr': lr, 'clean': clean, 'resid': resid, 'centers': ctr,
            'stds': stds, 'means': means}


def noise_model_plot(hr_u8: np.ndarray, lr_u8: np.ndarray, scale: int,
                     out_path: str,
                     study: Optional[Dict[float, Dict]] = None) -> str:
    """Noise study figure (reference dlib/diagnosis/noise.py): the real
    LR acquisition vs the clean downscale of HR — residual map,
    residual histogram, std-vs-intensity curve; optionally metric-vs-
    injected-noise curves from inference.super_res.noise_study."""
    plt = _plt('noise_model_plot')
    nr = noise_residual(hr_u8, lr_u8)
    resid, lr = nr['resid'], nr['lr']

    ncols = 4 + (1 if study else 0)
    fig, axes = plt.subplots(1, ncols, figsize=(3.0 * ncols, 3.0))
    im = axes[0].imshow(resid, cmap='coolwarm', vmin=-40, vmax=40)
    axes[0].set_title('LR - downscale(HR)', fontsize=8)
    axes[0].axis('off')
    fig.colorbar(im, ax=axes[0], fraction=0.046)
    axes[1].hist(resid.ravel(), bins=81, color='#444')
    axes[1].set_title(f'residual hist (std={resid.std():.2f})',
                      fontsize=8)
    axes[2].plot(nr['centers'], nr['stds'], marker='o', label='std')
    axes[2].plot(nr['centers'], nr['means'], marker='.', label='mean')
    axes[2].set_xlabel('clean intensity')
    axes[2].set_title('noise vs intensity', fontsize=8)
    axes[2].legend(fontsize=7)
    axes[2].grid(alpha=.3)
    axes[3].imshow(lr, cmap='magma')
    axes[3].set_title('real LR', fontsize=8)
    axes[3].axis('off')
    if study:
        sig = sorted(study.keys())
        for metric in ('psnr', 'ssim'):
            vals = [study[s].get(metric) for s in sig]
            if all(v is not None for v in vals):
                axes[4].plot(sig, vals, marker='o', label=metric)
        axes[4].set_xlabel('injected noise sigma')
        axes[4].set_title('robustness', fontsize=8)
        axes[4].legend(fontsize=7)
        axes[4].grid(alpha=.3)
    fig.tight_layout()
    _ensure_dir(out_path)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# ----------------------------------------------------------------- color
def color_distribution(images_by_cell: Dict[str, Sequence[np.ndarray]],
                       out_path: str) -> str:
    """Per-cell intensity histograms + CDFs (reference color-dist
    study): one row per cell type."""
    plt = _plt('color_distribution')
    cells = list(images_by_cell.keys())
    fig, axes = plt.subplots(len(cells), 2,
                             figsize=(8, 2.4 * len(cells)),
                             squeeze=False)
    for r, cell in enumerate(cells):
        vals = np.concatenate([np.asarray(im).ravel()
                               for im in images_by_cell[cell]])
        h, edges = np.histogram(vals, bins=256, range=(0, 255),
                                density=True)
        axes[r, 0].plot(edges[:-1], h)
        axes[r, 0].set_yscale('log')
        axes[r, 0].set_title(f'{cell}: intensity pdf '
                             f'(mean={vals.mean():.1f})', fontsize=8)
        axes[r, 1].plot(edges[:-1], np.cumsum(h) / h.sum())
        axes[r, 1].set_title(f'{cell}: cdf', fontsize=8)
        for ax in axes[r]:
            ax.grid(alpha=.3)
    fig.tight_layout()
    _ensure_dir(out_path)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# --------------------------------------------------------------- restore


def restore_captions(panels: List[np.ndarray], titles: List[str],
                     hr: np.ndarray) -> List[str]:
    """Each panel's caption: its title, and where the (H, W) panel has
    the HR's shape (and is not the HR) its PSNR / SSIM against the HR,
    border 0, on the CPU."""
    hr = np.asarray(hr).astype(np.float32)
    ha = torch.from_numpy(hr)[None, None]
    caps = []
    for img, t in zip(panels, titles):
        a = np.asarray(img).astype(np.float32)
        if a.shape == hr.shape and t != 'HR':
            ea = torch.from_numpy(a)[None, None]
            p = float(M.mb_psnr(ea, ha, border=0)[0])
            s = float(M.mb_ssim(ea, ha, border=0)[0])
            caps.append(f'{t}\nPSNR {p:.2f} / SSIM {s:.4f}')
        else:
            caps.append(t)
    return caps


def restore_grid(panels: List[np.ndarray], titles: List[str],
                 hr: np.ndarray, out_path: str,
                 gif_path: Optional[str] = None) -> str:
    """The panels and the HR in one row, captioned (restore_captions),
    written to out_path (matplotlib, Agg); with gif_path also a GIF of
    the panels, each with its caption's first line (imageio, cv2).
    Returns out_path."""
    plt = _plt('restore_grid')
    if gif_path:
        imageio = _require('imageio.v2', 'restore_grid with a GIF')
        cv2 = _require('cv2', 'restore_grid with a GIF')
    hr = np.asarray(hr).astype(np.float32)
    caps = restore_captions(panels, titles, hr)
    n = len(panels) + 1
    fig, axes = plt.subplots(1, n, figsize=(2.8 * n, 3.4))
    for ax, img, c in zip(axes, list(panels) + [hr], caps + ['HR']):
        ax.imshow(np.asarray(img), cmap='magma', vmin=0, vmax=255)
        ax.set_title(c, fontsize=7)
        ax.axis('off')
    fig.tight_layout()
    _ensure_dir(out_path)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)

    if gif_path:
        frames = []
        for img, c in zip(list(panels) + [hr], caps + ['HR']):
            f = np.stack([np.asarray(img).astype(np.uint8)] * 3, -1)
            cv2.putText(f, c.split('\n')[0], (4, 18),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                        cv2.LINE_AA)
            frames.append(f)
        _ensure_dir(gif_path)
        imageio.mimsave(gif_path, frames, duration=0.8, loop=0)
    return out_path
