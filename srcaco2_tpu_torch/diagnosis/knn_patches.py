"""Exact-KNN patch-exemplar SR demo (port of
srcaco2_tpu/diagnosis/knn_patches.py).

Reference analog: dlib/diagnosis/knn_demo_patches.py — builds a
dictionary mapping every distinct LR sz x sz patch seen in training to
the empirical distribution of the HR 2x2 atoms it co-occurs with
(build_mapping, :579), then reconstructs test images by nearest-
neighbour lookup over the dictionary with a ring-weighted L1 distance
(get_ring :909, argKmin :989) and categorical sampling of the HR atom,
folding the sampled 2x2 atoms back into an image. The study quantifies
how far pure patch recurrence (no learned model) gets on this data.

The dictionary build is numpy (JAX's group-by; its fill vectorized).
The exact k-NN runs in torch on the card unless device='cpu': the
ring-weighted L1 distances of a block of queries against a block of
dictionary rows, accumulated feature by feature in f32 as
dist += |q_j - d_j| * r_j (in place, two (rows, columns) tensors; the
blocks sized to the device's free memory). torch.cdist(p=1) over the
ring-scaled rows gives the same distances, but knn_restore of one 512^2
image (65,536 queries) against 940,589 rows took 80.0 s through it and
5.4 s through these passes on an NVIDIA H100 80GB HBM3 at 700 W
(chip_smoke.py's diagnosis_check).
The k nearest are taken by repeated argmin, whose first-index rule puts
the lower dictionary index first among equal distances, as lax.top_k
does, and the blocks are merged in dictionary order so that the rule
holds across them. With uint8 patches and integer ring weights (the
demo's) every product, difference and partial sum is an exact integer
in f32, so the distances equal JAX's bit for bit and the neighbours do
not depend on the device or the blocking: they equal JAX's index for
index, ties included.

Sampling departs from JAX on purpose: jax.random's draws cannot be
reproduced in torch, so the neighbour pick and the atom draw come from a
torch.Generator on the CPU seeded with `seed` (the same draws on any
device). A dictionary whose entries hold one atom each, with k = 1,
gives a deterministic result, equal to JAX's.
"""
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from srcaco2_tpu_torch import resolve_device


def ring_weights(sz: int, c: float = 300.0) -> np.ndarray:
    """Concentric weighting of the reference get_ring: ring k (from
    the border) weighs k+1, except the center ring which weighs
    ceil(sz/2)*c — the center pixel dominates the distance."""
    assert sz % 2 == 1, sz
    if sz == 1:
        return np.ones((1, 1), np.float32)
    z = (sz + 1) // 2
    p = [(i + 1) * (c if i == z - 1 else 1.0) for i in range(z)]
    p = p[::-1]                        # center first
    a = np.full((1, 1), p[0], np.float32)
    for v in p[1:]:
        a = np.pad(a, 1, constant_values=v)
    return a


def extract_pairs(l_img: np.ndarray, h_img: np.ndarray, sz: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(LR patch, HR atom) training pairs: every sz x sz LR window
    (reflect-padded so each window centers one LR pixel) paired with
    the 2x2 HR block that pixel maps to at x2. Returns
    (N, sz*sz) uint8 and (N, 4) uint8."""
    assert l_img.ndim == 2 and h_img.ndim == 2
    hh, ww = l_img.shape
    assert h_img.shape == (2 * hh, 2 * ww), (l_img.shape, h_img.shape)
    p = sz // 2
    lp = np.pad(l_img, p, mode='reflect')
    lw = np.lib.stride_tricks.sliding_window_view(lp, (sz, sz))
    lw = lw.reshape(hh * ww, sz * sz)
    hp = h_img.reshape(hh, 2, ww, 2).transpose(0, 2, 1, 3)
    hp = hp.reshape(hh * ww, 4)
    return np.ascontiguousarray(lw), np.ascontiguousarray(hp)


def build_dict(pairs: List[Tuple[np.ndarray, np.ndarray]], sz: int
               ) -> Dict[str, np.ndarray]:
    """Group all training (LR patch, HR atom) pairs by distinct LR
    patch. Returns padded arrays:
      atoms_l (M, sz*sz) f32, atoms_h (M, A, 4) f32,
      probs (M, A) f32 (zero-padded empirical distribution),
      n (M,) int32 atoms per entry."""
    lw = np.concatenate([p[0] for p in pairs], 0)
    hp = np.concatenate([p[1] for p in pairs], 0)
    uniq_l, inv = np.unique(lw, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    # group (l index, h atom) and count co-occurrences
    key = np.concatenate([inv[:, None].astype(np.uint32).view(np.uint8)
                          .reshape(len(inv), -1), hp], 1)
    uk, counts = np.unique(key, axis=0, return_counts=True)
    li = uk[:, :4].copy().view(np.uint32).reshape(-1).astype(np.int64)
    ha = uk[:, 4:]
    order = np.argsort(li, kind='stable')
    li, ha, counts = li[order], ha[order], counts[order]
    m = len(uniq_l)
    n_per = np.bincount(li, minlength=m)
    a_max = int(n_per.max())
    atoms_h = np.zeros((m, a_max, 4), np.float32)
    probs = np.zeros((m, a_max), np.float32)
    starts = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    # the (entry, slot) of each (LR patch, HR atom) group, in order
    slot = np.arange(len(li)) - starts[li]
    atoms_h[li, slot] = ha
    probs[li, slot] = counts / np.bincount(li, weights=counts,
                                           minlength=m)[li]
    return {'atoms_l': uniq_l.astype(np.float32), 'atoms_h': atoms_h,
            'probs': probs, 'n': n_per.astype(np.int32), 'sz': sz}


def _kmin(v: torch.Tensor, i: torch.Tensor, k: int):
    """The k smallest of each row of values `v` with their indices `i`,
    ordered by value, the earlier column first among equal values
    (repeated argmin: torch.min returns the first minimal index)."""
    if k > 1:
        v = v.clone()
    rows = torch.arange(v.shape[0], device=v.device)
    vals, idxs = [], []
    for step in range(k):
        m, j = v.min(1)
        vals.append(m)
        idxs.append(i.gather(1, j[:, None])[:, 0] if i.dim() == 2
                    else i[j])
        if step < k - 1:
            v[rows, j] = float('inf')
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def _blocks(n: int, m: int, chunk: Optional[int], device,
            rows: Optional[int] = None) -> Tuple[int, int]:
    """(query rows, dictionary rows) per block: `chunk` queries (2048 by
    default, JAX's chunk) against `rows` dictionary rows, by default as
    many as keep the block's f32 distances and the argmin's copy within a
    quarter of the device's free memory (1 GiB on the CPU)."""
    cq = min(n, chunk or 2048)
    if rows:
        return cq, min(m, rows)
    if device.type == 'cuda':
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = 1 << 30
    return cq, max(1, min(m, budget // (8 * max(cq, 1))))


def chunked_knn(queries, atoms_l, ring, k: int = 1,
                chunk: Optional[int] = None, device=None,
                rows: Optional[int] = None) -> torch.Tensor:
    """Exact ring-weighted-L1 k-NN of (n, f) queries over (M, f)
    dictionary rows, on `device` (default the card). Returns (n, k)
    int64 neighbour indices on that device, nearest first, the lower
    index first among equal distances (lax.top_k's order). The blocks
    (_blocks: `chunk` queries by `rows` dictionary rows, or as many rows
    as fit) do not change the result. Shared by knn_restore and
    patch_dict's knn fallback."""
    dev = resolve_device(device)
    ring = [float(v) for v in np.asarray(ring, np.float32).reshape(-1)]
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
    # (f, M): a feature's row read contiguously
    d = torch.as_tensor(np.asarray(atoms_l, np.float32).T.copy(), device=dev)
    n, m = q.shape[0], d.shape[1]
    cq, cm = _blocks(n, m, chunk, dev, rows)
    out = []
    for a in range(0, n, cq):
        qa = q[a:a + cq]
        best_v = best_i = None
        for b in range(0, m, cm):
            db = d[:, b:b + cm]
            dist = torch.zeros((qa.shape[0], db.shape[1]),
                               dtype=torch.float32, device=dev)
            tmp = torch.empty_like(dist)
            for j, r in enumerate(ring):
                torch.sub(qa[:, j:j + 1], db[j:j + 1], out=tmp)
                dist.add_(tmp.abs_(), alpha=r)
            del tmp
            kk = min(k, db.shape[1])
            v, i = _kmin(dist, torch.arange(b, b + db.shape[1],
                                            device=dev), kk)
            if best_v is None:
                best_v, best_i = v, i
            else:       # the earlier blocks' candidates first: lower index
                best_v, best_i = _kmin(torch.cat([best_v, v], 1),
                                       torch.cat([best_i, i], 1),
                                       min(k, best_v.shape[1] + kk))
        out.append(best_i)
    return torch.cat(out, 0)


def knn_draws(n: int, k: int, seed: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of knn_restore, from a CPU torch.Generator seeded with
    `seed`: the neighbour pick (n,) uniform in [0, k), then one float64
    uniform (n, 1) per pixel, which picks the atom by the inverse CDF of
    the matched entry's distribution (the number of cumulative sums it
    exceeds, clamped to the last atom)."""
    gen = torch.Generator().manual_seed(int(seed))
    pick = torch.randint(0, k, (n,), generator=gen)
    u = torch.rand((n, 1), generator=gen, dtype=torch.float64)
    return pick, u


def knn_restore(l_img: np.ndarray, dictionary: Dict, k: int = 1,
                seed: int = 0, chunk: Optional[int] = None,
                ring_c: float = 300.0, device=None) -> np.ndarray:
    """Reconstruct the x2 HR image of `l_img` by exact k-NN over the
    dictionary (ring-weighted L1, on `device`, default the card),
    sampling one HR atom per pixel from the matched entry's empirical
    distribution (k>1: a uniformly chosen neighbour's distribution; the
    draws: knn_draws). Returns uint8 (2h, 2w)."""
    dev = resolve_device(device)
    sz = dictionary['sz']
    queries, _ = extract_pairs(l_img, np.zeros(
        (2 * l_img.shape[0], 2 * l_img.shape[1]), l_img.dtype), sz)
    n = queries.shape[0]
    nbr = chunked_knn(queries, dictionary['atoms_l'],
                      ring_weights(sz, ring_c).reshape(-1), k=k,
                      chunk=chunk, device=dev)            # (n, k)
    probs = torch.as_tensor(dictionary['probs'], device=dev)
    atoms_h = torch.as_tensor(dictionary['atoms_h'], device=dev)
    pick, u = knn_draws(n, k, seed)
    ent = nbr.gather(1, pick.to(dev)[:, None])[:, 0]      # (n,)
    c = probs[ent].double().cumsum(1)
    a_i = torch.clamp((u.to(dev) > c).sum(1), max=probs.shape[1] - 1)
    atoms = atoms_h[ent, a_i].cpu().numpy()               # (n, 4)
    hh, ww = l_img.shape
    out = atoms.reshape(hh, ww, 2, 2).transpose(
        0, 2, 1, 3).reshape(2 * hh, 2 * ww)
    return np.clip(out, 0, 255).astype(np.uint8)


def run_knn_demo(data_root: str, splits_root: str, train_ds: str,
                 test_ds: str, out_dir: str, sz_l: int = 3,
                 kn: int = 1, n_train: Optional[int] = None,
                 n_test: int = 2, seed: int = 0, device=None) -> Dict:
    """Full demo matching the reference flow: build the dictionary
    from the train fold, knn-restore test images, and write a summary
    {dict_size, avg_atoms, psnr_knn, psnr_bicubic} to log.txt; the
    comparison figure (GT / bicubic / knn) is drawn where matplotlib
    imports."""
    from srcaco2_tpu_torch.data import folds, io as dio
    from srcaco2_tpu_torch.data.dataset import ds_dir
    from srcaco2_tpu_torch.diagnosis import visualize as V
    from srcaco2_tpu_torch.ops import metrics as M

    os.makedirs(out_dir, exist_ok=True)
    data_root = os.path.join(data_root, ds_dir(train_ds))
    pairs_lh, _ = folds.get_pairs(splits_root, train_ds)
    if n_train:
        pairs_lh = pairs_lh[:n_train]
    train_pairs = []
    for l_rel, h_rel in pairs_lh:
        li = dio.imread_uint(os.path.join(data_root, l_rel), 1)[..., 0]
        hi = dio.imread_uint(os.path.join(data_root, h_rel), 1)[..., 0]
        if hi.shape[0] != 2 * li.shape[0]:
            continue                       # demo is defined for x2
        train_pairs.append(extract_pairs(li, hi, sz_l))
    assert train_pairs, 'no x2 train pairs found'
    dictionary = build_dict(train_pairs, sz_l)

    test_lh, _ = folds.get_pairs(splits_root, test_ds)
    psnrs_knn, psnrs_bi = [], []
    for i, (l_rel, h_rel) in enumerate(test_lh[:n_test]):
        li = dio.imread_uint(os.path.join(data_root, l_rel), 1)[..., 0]
        hi = dio.imread_uint(os.path.join(data_root, h_rel), 1)[..., 0]
        if hi.shape[0] != 2 * li.shape[0]:
            continue
        rec = knn_restore(li, dictionary, k=kn, seed=seed + i,
                          device=device)
        bic = dio.cv2_resize_cubic_uint8(
            li, (hi.shape[1], hi.shape[0]))[..., 0]

        def psnr(a):
            e = torch.as_tensor(a, dtype=torch.float32)[None, None]
            h = torch.as_tensor(hi, dtype=torch.float32)[None, None]
            return float(M.mb_psnr(e, h, border=2)[0])
        psnrs_knn.append(psnr(rec))
        psnrs_bi.append(psnr(bic))
        if V.has_matplotlib():
            V.restore_grid(
                [bic.astype(np.float32), rec.astype(np.float32)],
                [f'bicubic ({psnrs_bi[-1]:.2f} dB)',
                 f'knn-{kn} {sz_l}x{sz_l} ({psnrs_knn[-1]:.2f} dB)'],
                hi.astype(np.float32),
                os.path.join(out_dir, f'knn_demo_{i}.png'))
    summary = {
        'dict_size': int(len(dictionary['atoms_l'])),
        'avg_atoms_per_entry': float(dictionary['n'].mean()),
        'sz_l': sz_l, 'kn': kn,
        'psnr_knn': float(np.mean(psnrs_knn)) if psnrs_knn else None,
        'psnr_bicubic': float(np.mean(psnrs_bi)) if psnrs_bi else None,
    }
    with open(os.path.join(out_dir, 'log.txt'), 'w') as f:
        f.write(repr(summary) + '\n')
    return summary
