"""The restore grid (port of srcaco2_tpu/diagnosis/visualize.py:
restore_grid): LR / bicubic / per-method / HR panels side by side, each
captioned with its PSNR / SSIM against the HR, and an optional GIF that
cycles the panels.

matplotlib, imageio and cv2 are imported only when a figure is drawn;
where one is missing, restore_grid raises an ImportError that names it
(the card's machine has no matplotlib). The captions need none of them.
"""
import importlib
import os
from typing import List, Optional

import numpy as np
import torch

from srcaco2_tpu_torch.ops import metrics as M


def _require(module: str, purpose: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f'{purpose} needs {module}, which does not '
                          f'import here: {e}') from e


def _ensure_dir(path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


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
    matplotlib = _require('matplotlib', 'restore_grid')
    matplotlib.use('Agg')
    plt = _require('matplotlib.pyplot', 'restore_grid')
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
