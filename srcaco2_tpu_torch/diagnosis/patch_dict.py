"""Patch-dictionary (atom) SR studies: exact / mixed reconstruction
(port of srcaco2_tpu/diagnosis/patch_dict.py).

Reference analog: dlib/diagnosis/patches.py and demo_patches.py — the
exemplar-SR upper-bound studies behind the paper's data analysis.
There, `build_mapping` (patches.py:560) hashes every distinct LR
sz x sz patch of an image to the empirical distribution of the HR 2x2
atoms it co-occurs with; `exact_l_to_h` (:698) reconstructs an image
whose every patch is IN the dictionary (the self-reconstruction /
patch-recurrence study), `low_to_h_mixed` (demo_patches.py:787) uses
the exact entry when the query hash is present and falls back to the
nearest dictionary atom otherwise, and `get_stats` (:708) +
histogram/x-y figures quantify dictionary size, atom multiplicity and
the LR->HR intensity relation.

The studies answer two data questions the paper cares about:
 1. how AMBIGUOUS is the LR->HR mapping at patch scale (multiple HR
    atoms per identical LR patch -> even a perfect exemplar method has
    an error floor), and
 2. how far pure patch RECURRENCE (no learned model) gets on unseen
    images, as a non-parametric baseline between bicubic and trained
    nets.

The per-patch Python hash loops are one vectorized np.unique group-by
(shared with knn_patches.build_dict); exact lookup is a bytes-dict built
once over the unique LR atoms; the sampling is numpy's (_sample_rows on
default_rng(seed)), as in the JAX package, so a reconstruction equals
JAX's bit for bit; the KNN fallback is knn_patches.chunked_knn, on the
card unless device='cpu'. The study figure is drawn where matplotlib
imports. The
reference's unpadded stride-1 unfold keeps n_lr_pixels == n_hr_atoms
only because it feeds the same image twice; here extract_pairs
(reflect-padded, centered) provides that invariant for any x2 pair.
"""
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from srcaco2_tpu_torch.diagnosis.knn_patches import (
    build_dict, chunked_knn, extract_pairs, ring_weights)
from srcaco2_tpu_torch.diagnosis.visualize import has_matplotlib


def _hash_index(dictionary: Dict) -> Dict[bytes, int]:
    """bytes(LR patch uint8) -> dictionary row, built once."""
    atoms_u8 = dictionary['atoms_l'].astype(np.uint8)
    return {a.tobytes(): i for i, a in enumerate(atoms_u8)}


def _sample_rows(probs: np.ndarray, rng) -> np.ndarray:
    """Inverse-CDF sample one atom index per row of (n, A) probs.
    The float32 cumsum tail can undershoot 1.0 by ~5e-7, in which
    case `u > all bins` would index A (out of bounds) — clamp."""
    c = probs.cumsum(1)
    u = rng.random((len(c), 1))
    return np.minimum((u > c).sum(1), probs.shape[1] - 1)


def dict_stats(dictionary: Dict) -> Dict:
    """Reference get_stats (patches.py:675) aggregated over the whole
    dictionary: size, atom-multiplicity distribution, and the
    LR->HR ambiguity rate (entries with >1 distinct HR atom)."""
    n = dictionary['n']
    probs = dictionary['probs']
    # entropy of each entry's empirical HR-atom distribution (bits):
    # 0 for deterministic entries; the mean is the ambiguity floor.
    p = np.where(probs > 0, probs, 1.0)
    ent = -(probs * np.log2(p)).sum(1)
    return {
        'dict_size': int(len(n)),
        'avg_atoms_per_entry': float(n.mean()),
        'max_atoms_per_entry': int(n.max()),
        'frac_ambiguous': float((n > 1).mean()),
        'mean_entropy_bits': float(ent.mean()),
        'atoms_hist': np.bincount(n, minlength=2)[1:].tolist(),
    }


def exact_match_restore(l_img: np.ndarray, dictionary: Dict,
                        fallback: str = 'knn', seed: int = 0,
                        sample: bool = True, chunk: int = 2048,
                        ring_c: float = 300.0, device=None
                        ) -> Tuple[np.ndarray, float]:
    """Reconstruct the x2 HR image by EXACT dictionary lookup
    (reference exact_l_to_h / low_to_h_mixed): every LR patch whose
    exact uint8 pattern is a dictionary entry gets an HR atom from
    that entry (sampled from the empirical distribution if `sample`,
    else the argmax-probability atom); misses fall back to the
    nearest dictionary atom ('knn') or bicubic pixels ('bicubic').

    Returns (uint8 (2h, 2w) reconstruction, exact-coverage fraction).
    The knn fallback runs on `device` (default the card).
    """
    sz = dictionary['sz']
    queries, _ = extract_pairs(l_img, np.zeros(
        (2 * l_img.shape[0], 2 * l_img.shape[1]), l_img.dtype), sz)
    qu8 = queries.astype(np.uint8)
    index = _hash_index(dictionary)
    ent = np.array([index.get(r.tobytes(), -1) for r in qu8],
                   np.int64)
    hit = ent >= 0
    coverage = float(hit.mean())
    rng = np.random.default_rng(seed)

    n = len(qu8)
    atoms = np.zeros((n, 4), np.float32)
    if hit.any():
        probs = dictionary['probs'][ent[hit]]          # (nh, A)
        if sample:
            a_i = _sample_rows(probs, rng)
        else:
            a_i = probs.argmax(1)
        atoms[hit] = dictionary['atoms_h'][ent[hit], a_i]

    miss = ~hit
    if miss.any():
        if fallback == 'knn':
            nn = chunked_knn(
                queries[miss], dictionary['atoms_l'],
                ring_weights(sz, ring_c).reshape(-1),
                chunk=chunk, device=device)[:, 0].cpu().numpy()
            pm = dictionary['probs'][nn]
            if sample:
                a_i = _sample_rows(pm, rng)
            else:
                a_i = pm.argmax(1)
            atoms[miss] = dictionary['atoms_h'][nn, a_i]
        elif fallback == 'bicubic':
            from srcaco2_tpu_torch.data.io import cv2_resize_cubic_uint8
            hh, ww = l_img.shape
            bic = cv2_resize_cubic_uint8(
                l_img, (2 * ww, 2 * hh))[..., 0].astype(np.float32)
            bic_atoms = bic.reshape(hh, 2, ww, 2).transpose(
                0, 2, 1, 3).reshape(n, 4)
            atoms[miss] = bic_atoms[miss]
        else:
            raise ValueError(fallback)

    hh, ww = l_img.shape
    out = atoms.reshape(hh, ww, 2, 2).transpose(0, 2, 1, 3).reshape(
        2 * hh, 2 * ww)
    return np.clip(out, 0, 255).astype(np.uint8), coverage


def _psnr(a: np.ndarray, h_img: np.ndarray) -> float:
    """PSNR (border 2) of a reconstruction against the HR, on the CPU."""
    from srcaco2_tpu_torch.ops import metrics as M
    e = torch.as_tensor(a, dtype=torch.float32)[None, None]
    h = torch.as_tensor(h_img, dtype=torch.float32)[None, None]
    return float(M.mb_psnr(e, h, border=2)[0])


def self_reconstruction(l_img: np.ndarray, h_img: np.ndarray,
                        sz: int = 3, seed: int = 0) -> Dict:
    """The reference's patch-recurrence study (patches.py
    process_scale): build the mapping FROM one (LR, HR) pair and
    exact-reconstruct that same pair. Coverage is 1 by construction;
    the reconstruction error measures pure LR->HR atom AMBIGUITY —
    the error floor of any exemplar method at this patch size."""
    pairs = [extract_pairs(l_img, h_img, sz)]
    dictionary = build_dict(pairs, sz)
    rec_s, cov = exact_match_restore(l_img, dictionary, seed=seed,
                                     sample=True)
    rec_m, _ = exact_match_restore(l_img, dictionary, seed=seed,
                                   sample=False)
    assert cov == 1.0, cov
    st = dict_stats(dictionary)
    st.update({'psnr_sampled': _psnr(rec_s, h_img),
               'psnr_mode': _psnr(rec_m, h_img), 'sz': sz})
    return st


def plot_dict_study(dictionary: Dict, l_img: np.ndarray,
                    h_img: np.ndarray, rec: np.ndarray,
                    coverage: float, out_path: str):
    """The study figure (reference _plot_histogram / _plot_x_y /
    _add_hexbin layouts, demo_patches.py:346-529): reconstruction
    panels, intensity histograms (HR vs reconstruction), the LR-vs-HR
    center-pixel hexbin, and the atom-multiplicity histogram."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(12, 7.5))
    for ax, img, tag in ((axes[0, 0], l_img, 'LR'),
                         (axes[0, 1], h_img, 'HR'),
                         (axes[0, 2], rec,
                          f'dict rec (cov {coverage:.1%})')):
        ax.imshow(img, cmap='magma', vmin=0, vmax=255)
        ax.set_title(tag, fontsize=9)
        ax.axis('off')
    bins = np.arange(257)
    axes[1, 0].hist(h_img.reshape(-1), bins=bins, histtype='step',
                    log=True, label='HR')
    axes[1, 0].hist(rec.reshape(-1), bins=bins, histtype='step',
                    log=True, label='rec')
    axes[1, 0].set_title('intensity histogram', fontsize=9)
    axes[1, 0].legend(fontsize=8)
    # LR center pixel vs the mean of its HR 2x2 block (x-y relation)
    hh, ww = l_img.shape
    hm = h_img.astype(np.float32).reshape(hh, 2, ww, 2).mean((1, 3))
    axes[1, 1].hexbin(l_img.reshape(-1), hm.reshape(-1), gridsize=48,
                      bins='log', cmap='viridis')
    axes[1, 1].set_xlabel('LR pixel', fontsize=8)
    axes[1, 1].set_ylabel('HR 2x2 mean', fontsize=8)
    axes[1, 1].set_title('LR vs HR intensity', fontsize=9)
    n = dictionary['n']
    axes[1, 2].hist(n, bins=np.arange(1, n.max() + 2) - 0.5,
                    log=True)
    axes[1, 2].set_title('HR atoms per LR entry', fontsize=9)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def run_patch_dict_study(data_root: str, splits_root: str,
                         train_ds: str, test_ds: str, out_dir: str,
                         sz_l: int = 3, n_train: Optional[int] = None,
                         n_test: int = 2, seed: int = 0,
                         device=None) -> Dict:
    """Full study over a built dataset (reference process_scale /
    demo_patches main flow): build the dictionary from the train
    fold, emit (a) dictionary/ambiguity stats, (b) per-test-image
    exact-coverage + mixed (exact-then-knn) reconstruction PSNR vs
    bicubic, (c) the study figure per image, and (d) a
    self-reconstruction ambiguity row. Writes summary.yaml (JSON
    without PyYAML, config/yaml_io); the figure only where matplotlib
    imports."""
    from srcaco2_tpu_torch.config import yaml_io
    from srcaco2_tpu_torch.data import folds, io as dio
    from srcaco2_tpu_torch.data.dataset import ds_dir

    os.makedirs(out_dir, exist_ok=True)
    img_root = os.path.join(data_root, ds_dir(train_ds))
    pairs_lh, _ = folds.get_pairs(splits_root, train_ds)
    if n_train:
        pairs_lh = pairs_lh[:n_train]
    train_pairs, first = [], None
    for l_rel, h_rel in pairs_lh:
        li = dio.imread_uint(os.path.join(img_root, l_rel), 1)[..., 0]
        hi = dio.imread_uint(os.path.join(img_root, h_rel), 1)[..., 0]
        if hi.shape[0] != 2 * li.shape[0]:
            continue                       # study is defined for x2
        if first is None:
            first = (li, hi)
        train_pairs.append(extract_pairs(li, hi, sz_l))
    assert train_pairs, 'no x2 train pairs found'
    dictionary = build_dict(train_pairs, sz_l)

    test_lh, _ = folds.get_pairs(splits_root, test_ds)
    rows = []
    for i, (l_rel, h_rel) in enumerate(test_lh[:n_test]):
        li = dio.imread_uint(os.path.join(img_root, l_rel), 1)[..., 0]
        hi = dio.imread_uint(os.path.join(img_root, h_rel), 1)[..., 0]
        if hi.shape[0] != 2 * li.shape[0]:
            continue
        rec, cov = exact_match_restore(li, dictionary, fallback='knn',
                                       seed=seed + i, device=device)
        bic = dio.cv2_resize_cubic_uint8(
            li, (hi.shape[1], hi.shape[0]))[..., 0]

        rows.append({'image': os.path.basename(h_rel),
                     'coverage': round(cov, 4),
                     'psnr_dict': round(_psnr(rec, hi), 3),
                     'psnr_bicubic': round(_psnr(bic, hi), 3)})
        if has_matplotlib():
            plot_dict_study(dictionary, li, hi, rec, cov,
                            os.path.join(out_dir, f'patch_dict_{i}.png'))

    summary = {
        'sz_l': sz_l,
        'stats': dict_stats(dictionary),
        'self_reconstruction': self_reconstruction(*first, sz=sz_l,
                                                   seed=seed),
        'test': rows,
    }
    path = os.path.join(out_dir, 'summary.yaml')
    if yaml_io.yaml is not None:
        with open(path, 'w') as f:
            yaml_io.yaml.safe_dump(summary, f, sort_keys=False)
    else:
        yaml_io.dump(summary, path)
    return summary
