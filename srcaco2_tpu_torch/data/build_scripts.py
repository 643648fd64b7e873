"""Offline dataset-building tools (a copy of
srcaco2_tpu/data/build_scripts.py on the port's data/io.py, numpy and
scipy on the host).

Capability parity with dlib/datasets/ds_scripts/ (caco2_resample.py:
raw-tile fixing, low/high registration, HR->LR divisions, cell-content
patch sampling, fold splitting; biosr.py; patch_sampler.py
SamplePatchesFromTile). These are host-side, run-once tools.

Registration: the reference uses dense optical flow
(skimage.registration.optical_flow_tvl1, caco2_resample.py:441);
this environment ships no skimage, so registration uses FFT
phase-correlation for the global shift (the dominant misalignment in
the microscope stacks) — subpixel via local COM refinement.

The three-channel tiles go through the port's data/io.py
(imread_unchanged, imsave_unchanged): with cv2 they read and write as
the JAX package's cv2 calls do (channels in cv2's order, 8- or 16-bit
kept as stored); without cv2, uncompressed TIFF through the numpy
codec, the same channel order and dtype.
"""
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import io as dio


# ------------------------------------------------------------ registration
def phase_correlation_shift(a: np.ndarray, b: np.ndarray,
                            subpixel: bool = True
                            ) -> Tuple[float, float]:
    """Translation (dy, dx) aligning b to a, via phase correlation;
    subpixel refines the integer peak by a 1-D parabolic fit per axis
    (wraparound neighbours)."""
    fa = np.fft.rfft2(a.astype(np.float64))
    fb = np.fft.rfft2(b.astype(np.float64))
    r = fa * np.conj(fb)
    r /= np.maximum(np.abs(r), 1e-12)
    corr = np.fft.irfft2(r, a.shape)
    py, px = np.unravel_index(np.argmax(corr), corr.shape)
    h, w = corr.shape

    def frac(c_m, c_0, c_p):
        den = c_m - 2.0 * c_0 + c_p
        if abs(den) < 1e-12:
            return 0.0
        d = 0.5 * (c_m - c_p) / den
        return float(np.clip(d, -0.5, 0.5))

    dy, dx = float(py), float(px)
    if subpixel:
        dy += frac(corr[(py - 1) % h, px], corr[py, px],
                   corr[(py + 1) % h, px])
        dx += frac(corr[py, (px - 1) % w], corr[py, px],
                   corr[py, (px + 1) % w])
    if dy > h // 2:
        dy -= h
    if dx > w // 2:
        dx -= w
    return float(dy), float(dx)


def register_translation(high: np.ndarray, low_up: np.ndarray
                         ) -> np.ndarray:
    """Shift low_up (already upscaled to high's size) onto high."""
    dy, dx = phase_correlation_shift(high, low_up)
    return np.roll(np.roll(low_up, int(round(dy)), axis=0),
                   int(round(dx)), axis=1)


# ----------------------------------------------------------------- tiling
def tile_image(img: np.ndarray, tile: int, stride: Optional[int] = None
               ) -> List[Tuple[int, int, np.ndarray]]:
    """Non-overlapping (or strided) tiles: [(y, x, tile_img)]."""
    stride = stride or tile
    h, w = img.shape[:2]
    out = []
    for y in range(0, h - tile + 1, stride):
        for x in range(0, w - tile + 1, stride):
            out.append((y, x, img[y:y + tile, x:x + tile]))
    return out


def cell_content_fraction(patch: np.ndarray, th: float = 4.0) -> float:
    return float((patch >= th).mean())


@dataclass
class SamplePatchesFromTile:
    """Patch sampler over one HR tile (+ aligned LR divisions):
    keeps patches with >= min_cell_frac cell content (reference:
    patches >= 20% cell content, doc/nutrition-label)."""
    patch: int = 512
    stride: int = 512
    min_cell_frac: float = 0.2
    th: float = 4.0

    def __call__(self, hr_tile: np.ndarray) -> List[Tuple[int, int]]:
        keep = []
        for y, x, p in tile_image(hr_tile, self.patch, self.stride):
            if cell_content_fraction(p, self.th) >= self.min_cell_frac:
                keep.append((y, x))
        return keep


# ---------------------------------------------------------------- builder
def build_caco2(raw_pairs: Dict[str, Dict[int, str]], out_root: str,
                cell: str, scales: Sequence[int] = (2, 4, 8),
                patch: int = 512, min_cell_frac: float = 0.2,
                splits: Tuple[float, float] = (0.74, 0.11),
                seed: int = 0, register: bool = True) -> Dict[str, int]:
    """Build the caco2 layout from raw tiles.

    raw_pairs: {tile_id: {1: hr_path, 2: lr2_path, 4: ..., 8: ...}} —
    per tile, the HR image and its real low-res acquisitions. Writes
    hr_div_{1,scales} patch tifs + fold files per (split, scale), split
    by TILE (so train/val/test never share a tile), and returns
    per-split patch counts.
    """
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(out_root, 'caco2')
    sampler = SamplePatchesFromTile(patch=patch,
                                    min_cell_frac=min_cell_frac)

    tile_ids = sorted(raw_pairs.keys())
    perm = rng.permutation(len(tile_ids))
    n_train = int(len(tile_ids) * splits[0])
    n_val = max(1, int(len(tile_ids) * splits[1]))
    split_of = {}
    for rank, idx in enumerate(perm):
        if rank < n_train:
            split_of[tile_ids[idx]] = constants.TRAINSET
        elif rank < n_train + n_val:
            split_of[tile_ids[idx]] = constants.VALIDSET
        else:
            split_of[tile_ids[idx]] = constants.TESTSET

    fold_lines = {(sp, sc): [] for sp in constants.SPLITS
                  for sc in scales}
    counts = {sp: 0 for sp in constants.SPLITS}

    for tid in tile_ids:
        paths = raw_pairs[tid]
        hr = dio.imread_uint(paths[1], 1)[:, :, 0]
        lows = {}
        for sc in scales:
            lo = dio.imread_uint(paths[sc], 1)[:, :, 0]
            if register:
                # register at HR resolution, then re-decimate.
                up = np.kron(lo, np.ones((sc, sc), lo.dtype))
                up = up[:hr.shape[0], :hr.shape[1]]
                reg = register_translation(hr, up)
                lo = reg[::sc, ::sc]
            lows[sc] = lo
        for y, x in sampler(hr):
            sp = split_of[tid]
            counts[sp] += 1
            base = f'tile_HighRes{patch}-{tid}_{y}_{x}_{cell}.tif'
            dio.imsave(hr[y:y + patch, x:x + patch],
                       os.path.join(img_dir, 'hr_div_1', base))
            for sc in scales:
                lp = patch // sc
                lbase = f'tile_LowRes{lp}-{tid}_{y}_{x}_{cell}.tif'
                dio.imsave(lows[sc][y // sc:y // sc + lp,
                                    x // sc:x // sc + lp],
                           os.path.join(img_dir, f'hr_div_{sc}', lbase))
                fold_lines[(sp, sc)].append(
                    (f'hr_div_{sc}/{lbase}', f'hr_div_1/{base}'))

    for (sp, sc), lines in fold_lines.items():
        ds_name = constants.caco2_name(sp, sc, cell)
        fd = os.path.join(out_root, 'folds', 'super-resolution', ds_name)
        os.makedirs(fd, exist_ok=True)
        with open(os.path.join(fd, 'l_h.txt'), 'w') as f:
            f.writelines(f'{l},{h}\n' for l, h in lines)
        with open(os.path.join(fd, 'h_l.txt'), 'w') as f:
            f.writelines(f'{h},{l}\n' for l, h in lines)
    return counts


def build_biosr(raw_pairs: Dict[str, Dict[int, str]], out_root: str,
                structure: str = 'CCP', **kw) -> Dict[str, int]:
    """BioSR layout builder (reference: ds_scripts/biosr.py) — same
    pipeline as caco2 with the biosr directory name."""
    counts = build_caco2(raw_pairs, out_root, cell=structure, **kw)
    src = os.path.join(out_root, 'caco2')
    dst = os.path.join(out_root, 'biosr')
    if os.path.isdir(src) and not os.path.isdir(dst):
        os.rename(src, dst)
    return counts


# =====================================================================
# Reference-parity raw-tiles -> dataset pipeline (caco2_resample.py).
# Stages: fix_tiles (session merge/renumber/channel-reorder,
# :84,310-440) -> register_tiles (dense low->high registration,
# :441-573) -> sample_patches_tree (>=20%-cell-content grid sampling
# with reference patch naming, ds_scripts/patch_sampler.py) ->
# make_folds (tile-level 4/3/rest split, :188-306). One command:
# build_caco2_from_raw. Multi-channel tiles are (3, h, w) uint8 like
# the reference's tifffile stacks (cells = channels).
# =====================================================================
import re as _re
import shutil as _shutil

CELL_INDEX = {constants.CELL0: 0, constants.CELL1: 1, constants.CELL2: 2}


def res_name(scale: int, hr_size: int) -> str:
    """Reference resolution folder names: HighRes1024 / LowRes512 /
    LowRes256 / LowRes128 (parameterized by the HR tile size)."""
    return f'HighRes{hr_size}' if scale == 1 else \
        f'LowRes{hr_size // scale}'


def _imread_chw(path: str) -> np.ndarray:
    """(3, h, w) tile in its stored dtype (uint8 or uint16), channels in
    cv2's (BGR) order; a gray tile is repeated over the three."""
    img = dio.imread_unchanged(path, 3)[..., ::-1]
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def _imsave_chw(img: np.ndarray, path: str):
    """Write a (3, h, w) tile as _imread_chw reads it (BGR, its dtype)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert img.ndim == 3 and img.shape[0] == 3, img.shape
    dio.imsave_unchanged(
        np.ascontiguousarray(img.transpose(1, 2, 0)[..., ::-1]), path)


@dataclass
class SessionSpec:
    """One acquisition session of raw tiles (the reference merges
    nov/oct/jul21/jul-aug21 sessions with per-session quirks —
    caco2_resample.py:84,310,338,367,405)."""
    res_dirs: Dict[int, str]        # {1: dir_of_HR_tifs, 2: ..., ...}
    tile_offset: int = 0            # Tile{i} -> Tile{i + offset}
    channel_order: Tuple[int, int, int] = (0, 1, 2)  # rewrite order


def fix_tiles(sessions: Sequence[SessionSpec], out_dir: str,
              hr_size: int = 1024,
              scales: Sequence[int] = (2, 4, 8)) -> List[int]:
    """Merge sessions into all-tiles/{ResName}/{ResName}-{n}.tif with
    globally unique tile numbers, re-ordered channels. Raw files must
    contain 'Tile<NUM>' in their basename. Returns the tile numbers."""
    tiles = []
    for sess in sessions:
        for scale in (1,) + tuple(scales):
            d = sess.res_dirs[scale]
            rn = res_name(scale, hr_size)
            for f in sorted(os.listdir(d)):
                if not f.endswith(('.tif', '.tiff', '.png')):
                    continue
                m = _re.search(r'Tile(\d+)', f)
                assert m, f'no Tile<N> in raw tile name {f}'
                n = int(m.group(1)) + sess.tile_offset
                img = _imread_chw(os.path.join(d, f))
                img = img[list(sess.channel_order)]
                _imsave_chw(img, os.path.join(out_dir, rn,
                                              f'{rn}-{n}.tif'))
                if scale == 1:
                    assert n not in tiles, f'duplicate tile number {n}'
                    tiles.append(n)
    return sorted(tiles)


def _block_flow(ref: np.ndarray, img: np.ndarray, grid: int = 4,
                max_shift: float = 24.0) -> Tuple[np.ndarray, np.ndarray]:
    """Dense smooth flow (v, u) mapping img onto ref: per-block phase
    correlation on a grid x grid partition, bilinearly interpolated to
    a full-resolution field — a compiled-env stand-in for the
    reference's TV-L1 optical flow (skimage unavailable), matching its
    smooth low-frequency character on microscope stacks."""
    from scipy.ndimage import zoom
    h, w = ref.shape
    vs = np.zeros((grid, grid), np.float64)
    us = np.zeros((grid, grid), np.float64)
    bh, bw = h // grid, w // grid
    for by in range(grid):
        for bx in range(grid):
            rb = ref[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw]
            ib = img[by * bh:(by + 1) * bh, bx * bw:(bx + 1) * bw]
            if rb.std() < 1e-3 or ib.std() < 1e-3:
                continue
            dy, dx = phase_correlation_shift(rb, ib)
            if abs(dy) <= max_shift and abs(dx) <= max_shift:
                # phase correlation gives the ROLL aligning img to ref;
                # the inverse-map warp samples img at (x + flow), so
                # the flow is the negated shift (skimage TV-L1
                # convention, caco2_resample.py:445-463).
                vs[by, bx], us[by, bx] = -dy, -dx
    v = zoom(vs, (h / grid, w / grid), order=1, mode='nearest')
    u = zoom(us, (h / grid, w / grid), order=1, mode='nearest')
    return v[:h, :w], u[:h, :w]


def _warp_f(img: np.ndarray, v: np.ndarray, u: np.ndarray,
            mode: str = 'nearest') -> np.ndarray:
    """Float inverse-map warp (no rounding) for iterative refinement."""
    from scipy.ndimage import map_coordinates
    h, w = img.shape
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    return map_coordinates(img.astype(np.float64), [rr + v, cc + u],
                           order=1, mode=mode)


def _block_flow_refine(ref: np.ndarray, img: np.ndarray,
                       grids: Sequence[int] = (2, 4, 8),
                       iters: int = 2,
                       max_shift: float = 24.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Iterative pyramid warp-and-refine flow (v, u) mapping img onto
    ref: coarse-to-fine over block-grid densities, re-estimating the
    RESIDUAL block flow of the currently-warped image at each pass and
    accumulating. Captures locally varying misalignment the single-pass
    4x4 estimate misses, with sub-pixel accuracy from the parabolic
    phase-correlation peak — the compiled-env equivalent of the
    reference's iterative TV-L1 refinement
    (caco2_resample.py:441-573)."""
    h, w = ref.shape
    v = np.zeros((h, w), np.float64)
    u = np.zeros((h, w), np.float64)
    shift_cap = max_shift
    for g in grids:
        for _ in range(iters):
            warped = _warp_f(img, v, u)
            dv, du = _block_flow(ref, warped, grid=g,
                                 max_shift=shift_cap)
            if not (np.any(dv) or np.any(du)):
                break
            v += dv
            u += du
        # residuals shrink as the estimate converges; so should the
        # plausible-shift gate (rejects spurious fine-grid peaks)
        shift_cap = max(4.0, shift_cap / 2.0)
    return v, u


def _warp(img: np.ndarray, v: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Inverse-map warp like skimage.transform.warp(mode=constant)."""
    from scipy.ndimage import map_coordinates
    h, w = img.shape
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    out = map_coordinates(img.astype(np.float32), [rr + v, cc + u],
                          order=1, mode='constant', cval=0.0)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _nearest_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """PIL-NEAREST convention (caco2_resample.py:492,513 uses
    Image.resize(resample=NEAREST)): the output pixel CENTER maps to
    the source coordinate, so an s-fold downsample picks row s*y +
    s//2 (the block center), not the corner s*y. The corner
    convention this function originally used shifted every built LR
    by (s-1)/2 px relative to its HR — a systematic ~1.5 px at x4
    that a 9x9 ridge probe on the built benchmark measured as ~2.2 dB
    of (spurious) restorable margin, and that the 8-way dihedral
    augmentation makes unlearnable for any translation-equivariant
    net (docs/QUALITY.md registration study)."""
    ys = np.minimum(((np.arange(oh) + 0.5) * img.shape[0] / oh
                     ).astype(int), img.shape[0] - 1)
    xs = np.minimum(((np.arange(ow) + 0.5) * img.shape[1] / ow
                     ).astype(int), img.shape[1] - 1)
    return img[ys][:, xs]


def register_im(ref_chw: np.ndarray, low_chw: np.ndarray, scale: int,
                del_border: int, global_shift: bool = False,
                pyramid: bool = True, method: Optional[str] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Register one low tile onto its HR tile (caco2_resample.py:469):
    nearest-upscale low to HR size, per-channel dense registration,
    crop del_border from both, nearest-downscale the registered low
    back to its scale. Returns (low_registered_chw, hr_cropped_chw).

    method selects the flow estimator: 'pyramid' (default — iterative
    block-flow warp-and-refine, measured BETTER than TV-L1 on the
    rigid component and ~40x cheaper, docs/QUALITY.md registration
    bound), 'block' (legacy single-pass 4x4 estimate), or 'tvl1' (the
    reference's exact algorithm, caco2_resample.py:441 — the
    pure-numpy reimplementation in diagnosis/tvl1_flow.py). The legacy
    pyramid=False bool maps to 'block' when method is unset. Rounded
    global shift overrides any dense field when global_shift."""
    if method is None:
        method = 'pyramid' if pyramid else 'block'
    if method == 'tvl1':
        from srcaco2_tpu_torch.diagnosis.tvl1_flow import optical_flow_tvl1
        flow_fn = optical_flow_tvl1
    else:
        flow_fn = {'pyramid': _block_flow_refine,
                   'block': _block_flow}[method]
    c, h, w = ref_chw.shape
    out = np.zeros_like(ref_chw)
    for i in range(c):
        up = _nearest_resize(low_chw[i], h, w)
        v, u = flow_fn(ref_chw[i].astype(np.float64) / 255.0,
                       up.astype(np.float64) / 255.0)
        if global_shift:
            v = np.full_like(v, np.round(v.mean()))
            u = np.full_like(u, np.round(u.mean()))
        out[i] = _warp(up, v, u)
    b = del_border
    if b:
        out = out[:, b:-b, b:-b]
        ref_chw = ref_chw[:, b:-b, b:-b]
    hh, ww = ref_chw.shape[1:]
    down = np.stack([_nearest_resize(out[i], hh // scale, ww // scale)
                     for i in range(c)])
    return down, ref_chw


def register_tiles(tiles_dir: str, out_dir: str, hr_size: int = 1024,
                   scales: Sequence[int] = (2, 4, 8),
                   del_border: int = 16,
                   global_shift: bool = False,
                   method: Optional[str] = None) -> int:
    """all-tiles -> all-tiles-registered (caco2_resample.py:755).
    NOTE: del_border must keep tile sizes divisible by max(scales)."""
    hr_rn = res_name(1, hr_size)
    n_done = 0
    for f in sorted(os.listdir(os.path.join(tiles_dir, hr_rn))):
        ref = _imread_chw(os.path.join(tiles_dir, hr_rn, f))
        regs = {}
        for sc in scales:
            rn = res_name(sc, hr_size)
            low = _imread_chw(os.path.join(
                tiles_dir, rn, f.replace(hr_rn, rn)))
            regs[sc], ref_c = register_im(ref, low, sc, del_border,
                                          global_shift, method=method)
        _imsave_chw(ref_c, os.path.join(out_dir, hr_rn, f))
        for sc in scales:
            rn = res_name(sc, hr_size)
            _imsave_chw(regs[sc], os.path.join(
                out_dir, rn, f.replace(hr_rn, rn)))
        n_done += 1
    return n_done


def sample_patches_tree(tiles_dir: str, out_dir: str,
                        hr_size: int = 1024, psize: int = 512,
                        scales: Sequence[int] = (2, 4, 8),
                        register_margin: int = 0,
                        use_registered: bool = True,
                        min_area: float = 0.2,
                        threshold: Optional[float] = 4.0,
                        ) -> Dict[str, int]:
    """Grid-sample patches from every tile into
    out_dir/hr_div_{1,scales}/tile_{Res}-{n}_{k}_{i}_{ii}_{j}_{jj}_{CELL}.tif
    (single-channel per cell, reference naming — get_info_patch
    parseable). Acceptance: >= min_area of the CELL2 crop >= threshold
    (Otsu per tile when threshold is None); when sampling UNregistered
    tiles, psize grows by 2*register_margin and acceptance is judged
    on the margin-cropped center (patch_sampler.py:140-152).
    shift = 3/4 * real_psize - 2*register_margin (25% overlap)."""
    real_psize = psize
    if not use_registered:
        psize = psize + 2 * register_margin
    else:
        assert register_margin == 0, register_margin
    shift = int(real_psize / 4) * 3 - 2 * register_margin
    hr_rn = res_name(1, hr_size)
    stats = {'nbr': 0, 'reject': 0}
    from srcaco2_tpu_torch.data.sampling import otsu_threshold

    for f in sorted(os.listdir(os.path.join(tiles_dir, hr_rn))):
        mtx = _imread_chw(os.path.join(tiles_dir, hr_rn, f))
        lows = {sc: _imread_chw(os.path.join(
            tiles_dir, res_name(sc, hr_size),
            f.replace(hr_rn, res_name(sc, hr_size))))
            for sc in scales}
        _, h, w = mtx.shape
        th = otsu_threshold(mtx[CELL_INDEX[constants.CELL2]]) \
            if threshold is None else threshold
        base = f.split('.')[0]
        patch_id = 0
        for i in range(0, h, shift):
            ii = i + psize
            if ii >= h:
                break
            for j in range(0, w, shift):
                jj = j + psize
                if jj >= w:
                    break
                x = mtx[CELL_INDEX[constants.CELL2], i:ii, j:jj]
                if psize != real_psize:
                    z = real_psize // 2
                    x = x[z:x.shape[0] - z, z:x.shape[1] - z]
                if (x >= th).sum() / float(x.size) < min_area:
                    stats['reject'] += 1
                    continue
                stats['nbr'] += 1
                for sc in (1,) + tuple(scales):
                    src = mtx if sc == 1 else lows[sc]
                    p = psize // sc
                    si, sj = i // sc, j // sc
                    rn = base if sc == 1 else res_name(sc, hr_size) + \
                        '-' + base.split('-')[-1]
                    for cell, ci in CELL_INDEX.items():
                        patch = src[ci, si:si + p, sj:sj + p]
                        name = (f'tile_{rn}_{patch_id}_{si}_{si + p}'
                                f'_{sj}_{sj + p}_{cell}.tif')
                        dio.imsave(patch, os.path.join(
                            out_dir, f'hr_div_{sc}', name))
                patch_id += 1
    return stats


def get_info_patch(path_p: str) -> dict:
    """Parse the reference patch naming (caco2_resample.py:119)."""
    b = os.path.basename(path_p).split('.')[0]
    o = b.split('_')
    return {'tile_sz': o[1].split('-')[0],
            'tile_nbr': o[1].split('-')[1], 'patch_id': o[2],
            'i': int(o[3]), 'ii': int(o[4]), 'j': int(o[5]),
            'jj': int(o[6]), 'cell': o[7]}


def make_folds(caco2_dir: str, splits_root: str, hr_size: int = 1024,
               scales: Sequence[int] = (2, 4, 8), n_test_tiles: int = 4,
               n_valid_tiles: int = 3, seed: int = 0,
               name: str = 'caco2') -> Dict[str, int]:
    """Tile-level split (4 test / 3 valid / rest train, shuffled) and
    l_h.txt/h_l.txt per (cell x scale x split)
    (caco2_resample.py:188-306). Patch sizes follow psize/scale."""
    rng = np.random.default_rng(seed)
    hr_files = sorted(f for f in os.listdir(
        os.path.join(caco2_dir, 'hr_div_1'))
        if f.endswith(f'_{constants.CELL0}.tif'))
    assert hr_files, 'no CELL0 patches in hr_div_1'
    tiles = sorted({get_info_patch(f)['tile_nbr'] for f in hr_files})
    order = [tiles[k] for k in rng.permutation(len(tiles))]
    tl = {constants.TESTSET: set(order[:n_test_tiles]),
          constants.VALIDSET: set(
              order[n_test_tiles:n_test_tiles + n_valid_tiles]),
          constants.TRAINSET: set(order[n_test_tiles + n_valid_tiles:])}
    assert tl[constants.TRAINSET], 'not enough tiles for a train split'
    psize = get_info_patch(hr_files[0])['ii'] - \
        get_info_patch(hr_files[0])['i']
    counts = {}
    for cell in (constants.CELL0, constants.CELL1, constants.CELL2):
        for sc in scales:
            for split, tset in tl.items():
                lines = []
                for f in hr_files:
                    info = get_info_patch(f)
                    if info['tile_nbr'] not in tset:
                        continue
                    hrel = 'hr_div_1/' + f.replace(
                        f'_{constants.CELL0}.tif', f'_{cell}.tif')
                    p = psize // sc
                    rn = res_name(sc, hr_size)
                    lname = (f"tile_{rn}-{info['tile_nbr']}_"
                             f"{info['patch_id']}_"
                             f"{info['i'] // sc}_{info['i'] // sc + p}_"
                             f"{info['j'] // sc}_{info['j'] // sc + p}_"
                             f'{cell}.tif')
                    lrel = f'hr_div_{sc}/{lname}'
                    assert os.path.isfile(os.path.join(caco2_dir, lrel)), lrel
                    lines.append((lrel, hrel))
                ds = constants.caco2_name(split, sc, cell)
                if name != 'caco2':
                    ds = ds.replace('caco2', name)
                fd = os.path.join(splits_root, 'folds',
                                  'super-resolution', ds)
                os.makedirs(fd, exist_ok=True)
                with open(os.path.join(fd, 'l_h.txt'), 'w') as fo:
                    fo.writelines(f'{l},{h}\n' for l, h in lines)
                with open(os.path.join(fd, 'h_l.txt'), 'w') as fo:
                    fo.writelines(f'{h},{l}\n' for l, h in lines)
                counts[ds] = len(lines)
    return counts


def build_caco2_from_raw(sessions: Sequence[SessionSpec], out_root: str,
                         hr_size: int = 1024, psize: int = 512,
                         scales: Sequence[int] = (2, 4, 8),
                         register: bool = True, del_border: int = 16,
                         global_shift: bool = False,
                         min_area: float = 0.2,
                         threshold: Optional[float] = 4.0,
                         n_test_tiles: int = 4, n_valid_tiles: int = 3,
                         seed: int = 0,
                         register_method: Optional[str] = None
                         ) -> Dict[str, int]:
    """ONE command: raw session tiles -> fixed tiles -> (registered
    tiles) -> >=min_area-cell-content patches at every scale/cell ->
    fold files. The resulting tree trains directly:
    data_root=splits_root=out_root."""
    tiles_dir = os.path.join(out_root, 'caco2-tiles', 'all-tiles')
    fix_tiles(sessions, tiles_dir, hr_size, scales)
    if register:
        reg_dir = os.path.join(out_root, 'caco2-tiles',
                               'all-tiles-registered')
        register_tiles(tiles_dir, reg_dir, hr_size, scales, del_border,
                       global_shift, method=register_method)
        # resolution FOLDER names keep the raw size (reference keeps
        # HighRes1024 naming after the registration border crop)
        src = reg_dir
    else:
        src = tiles_dir
    caco2_dir = os.path.join(out_root, 'caco2')
    if os.path.isdir(caco2_dir):
        _shutil.rmtree(caco2_dir)
    stats = sample_patches_tree(src, caco2_dir, hr_size, psize, scales,
                                use_registered=True,
                                min_area=min_area, threshold=threshold)
    counts = make_folds(caco2_dir, out_root, hr_size, scales,
                        n_test_tiles, n_valid_tiles, seed)
    counts['_sampled'] = stats['nbr']
    counts['_rejected'] = stats['reject']
    return counts
