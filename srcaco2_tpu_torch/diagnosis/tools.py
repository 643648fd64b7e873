"""Offline diagnosis tools (port of srcaco2_tpu/diagnosis/tools.py; on
the host: numpy, and torch on the CPU for the resize).

Capability parity with dlib/diagnosis/ (check_data.py, patches.py /
demo_patches.py, noise.py, restore.py, color_dist.py): dataset
integrity checks, patch statistics & ROI visualizations, noise-model
studies on LR/HR pairs, method restore comparisons, per-split color
distributions. `plot_patch_demo` needs matplotlib (raising an
ImportError that names it where it is missing, as on the card's
machine).
"""
import os
from typing import Dict, List

import numpy as np

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import folds as F
from srcaco2_tpu_torch.data.dataset import ds_dir


# ------------------------------------------------------------- check_data
def check_data(data_root: str, splits_root: str, ds_name: str,
               sample: int = 0) -> Dict:
    """Fold/data integrity: pair files parse, referenced files exist,
    keys unique, low/high counts match. sample>0 additionally decodes
    the first `sample` pairs and checks shapes/dtype."""
    l_h, h_l = F.get_pairs(splits_root, ds_name)
    base = os.path.join(data_root, ds_dir(ds_name))
    report = {'n_pairs': len(l_h), 'missing_low': 0, 'missing_high': 0,
              'dup_low': 0, 'dup_high': 0, 'decode_errors': []}
    lows = [l for l, _ in l_h]
    highs = [h for _, h in l_h]
    report['dup_low'] = len(lows) - len(set(lows))
    report['dup_high'] = len(highs) - len(set(highs))
    for l, h in l_h:
        if not os.path.isfile(os.path.join(base, l.split(
                constants.CODE_IDENTIFIER)[0])):
            report['missing_low'] += 1
        if not os.path.isfile(os.path.join(base, h.split(
                constants.CODE_IDENTIFIER)[0])):
            report['missing_high'] += 1
    if sample > 0:
        from srcaco2_tpu_torch.data.io import imread_uint
        split, scale, _ = constants.parse_caco2_name(ds_name)
        for l, h in l_h[:sample]:
            try:
                hi = imread_uint(os.path.join(base, h), 1)
                lo = imread_uint(os.path.join(base, l), 1)
                assert hi.shape[0] == lo.shape[0] * scale, \
                    (hi.shape, lo.shape)
            except Exception as e:
                report['decode_errors'].append(f'{h}: {e}')
    report['ok'] = (report['missing_low'] == 0
                    and report['missing_high'] == 0
                    and report['dup_low'] == 0
                    and report['dup_high'] == 0
                    and not report['decode_errors'])
    return report


# --------------------------------------------------------------- patches
def patch_stats(hr_stack: np.ndarray, th: float = 4.0) -> Dict:
    """Per-image cell-content fraction, mean/max intensity, plus global
    histogram (reference: diagnosis/patches.py)."""
    x = hr_stack[..., 0] if hr_stack.ndim == 4 else hr_stack
    roi_frac = (x >= th).mean(axis=(1, 2))
    return {
        'n': int(x.shape[0]),
        'roi_frac_mean': float(roi_frac.mean()),
        'roi_frac_min': float(roi_frac.min()),
        'roi_frac_max': float(roi_frac.max()),
        'intensity_mean': float(x.mean()),
        'intensity_p99': float(np.percentile(x, 99)),
        'hist': np.bincount(x.ravel(), minlength=256).tolist(),
    }


def plot_patch_demo(hr_img: np.ndarray, out_path: str,
                    sample_type: str = constants.SAMPLE_ROI,
                    psize: int = 128, n_draws: int = 64, seed: int = 0):
    """Visualize patch-origin sampling over the ROI/EDT heat map
    (reference: dataset_dpsr.test_sampling:1301)."""
    from srcaco2_tpu_torch.data import sampling as S
    from srcaco2_tpu_torch.diagnosis.visualize import _plt
    plt = _plt('plot_patch_demo')

    img = hr_img[..., 0] if hr_img.ndim == 3 else hr_img
    rng = np.random.default_rng(seed)
    pts = [S.sample_origin_host(rng, img, sample_type, psize)
           for _ in range(n_draws)]
    fig, axes = plt.subplots(1, 2, figsize=(9, 4.5))
    axes[0].imshow(img, cmap='magma')
    axes[0].set_title('image')
    if sample_type != constants.SAMPLE_UNIF:
        pmap = S.origin_prob_map(img, sample_type, psize)
        axes[1].imshow(pmap, cmap='viridis')
    else:
        axes[1].imshow(np.zeros_like(img), cmap='viridis')
    axes[1].set_title(f'{sample_type} origin prob + draws')
    for (y, x) in pts:
        axes[1].plot(x, y, 'r.', markersize=3)
    for ax in axes:
        ax.axis('off')
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


# ----------------------------------------------------------------- noise
def noise_model_study(hr_stack: np.ndarray, lr_stack: np.ndarray,
                      scale: int, nbins: int = 16) -> Dict:
    """Estimate noise std vs intensity from real LR/HR pairs: compare
    real LR against the bicubic-downscaled HR (reference:
    diagnosis/noise.py semantics). Returns binned (intensity, std)."""
    from srcaco2_tpu_torch.ops.resize import interpolate
    hr = torch.from_numpy(np.ascontiguousarray(
        hr_stack.astype(np.float32).transpose(0, 3, 1, 2)))
    clean = interpolate(hr, scale=1.0 / scale).numpy()
    real = lr_stack.astype(np.float32).transpose(0, 3, 1, 2)
    resid = real - clean
    inten = clean.ravel()
    r = resid.ravel()
    edges = np.linspace(0, 255, nbins + 1)
    centers, stds, counts = [], [], []
    for i in range(nbins):
        m = (inten >= edges[i]) & (inten < edges[i + 1])
        if m.sum() < 16:
            continue
        centers.append(float((edges[i] + edges[i + 1]) / 2))
        stds.append(float(r[m].std()))
        counts.append(int(m.sum()))
    return {'intensity': centers, 'noise_std': stds, 'count': counts,
            'global_std': float(r.std())}


# ------------------------------------------------------------ color_dist
def color_distribution(stacks: Dict[str, np.ndarray]) -> Dict[str, list]:
    """Normalized 256-bin histograms per named split."""
    out = {}
    for name, x in stacks.items():
        h = np.bincount(np.asarray(x).ravel(), minlength=256
                        ).astype(np.float64)
        out[name] = (h / h.sum()).tolist()
    return out


# -------------------------------------------------------------- restore
def restore_comparison(exp_paths: List[str], out_path: str,
                       sample_idx: int = 0, device=None) -> str:
    """Method comparison figure (delegates to inference.super_res; the
    models run on `device`, default the card)."""
    from srcaco2_tpu_torch.inference.super_res import comparison_figure
    return comparison_figure(exp_paths, out_path, sample_idx,
                             device=device)
