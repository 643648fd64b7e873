"""Synthetic SR-CACO-2-like dataset generator (a copy of
srcaco2_tpu/data/synthetic.py: the same numpy draws, so one seed gives
the same pixels in both packages).

The real dataset (1.8 GB of microscope tiles) is not shipped; tests, CI and
benchmarks use this generator: blobby fluorescence-like grayscale cells on
a dark background, written as HR tifs + real-LR tifs + fold files in the
exact layout the loaders expect (data_root/caco2/hr_div_{1,scale}/..., and
splits_root/folds/super-resolution/<ds_name>/{l_h.txt,h_l.txt}).
"""
import os
from typing import List

import numpy as np

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import io as dio


def _box_blur(img: np.ndarray, r: int) -> np.ndarray:
    """Separable box blur of radius r via cumsum (edge-clamped)."""
    if r <= 0:
        return img
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r + 1, r)
        p = np.pad(img, pad, mode='edge')
        c = np.cumsum(p, axis=axis, dtype=np.float64)
        n = 2 * r + 1
        if axis == 0:
            img = (c[n:, :] - c[:-n, :]) / n
        else:
            img = (c[:, n:] - c[:, :-n]) / n
    return img.astype(np.float32)


def _smooth_noise(rng: np.random.Generator, size: int, scale_px: float,
                  amp: float) -> np.ndarray:
    """Band-limited texture: white noise box-blurred to ~scale_px
    granularity (3 passes approximate a Gaussian), renormalized to
    unit std then scaled by amp."""
    z = rng.normal(0, 1, (size, size)).astype(np.float32)
    r = max(1, int(round(scale_px / 2)))
    for _ in range(3):
        z = _box_blur(z, r)
    s = z.std()
    return z * (amp / (s + 1e-8))


def _splat(img: np.ndarray, ys, xs, sigmas, amps, rad: int = 5):
    """Add subpixel Gaussian stamps at float positions (vectorized
    per-stamp window insertion)."""
    size = img.shape[0]
    off = np.arange(-rad, rad + 1, dtype=np.float32)
    for y, x, s, a in zip(ys, xs, sigmas, amps):
        iy, ix = int(round(y)), int(round(x))
        if not (0 <= iy < size and 0 <= ix < size):
            continue
        dy = off + (iy - y)
        dx = off + (ix - x)
        g = np.exp(-(dy[:, None] ** 2 + dx[None, :] ** 2)
                   / (2 * s * s)) * a
        y0, y1 = max(0, iy - rad), min(size, iy + rad + 1)
        x0, x1 = max(0, ix - rad), min(size, ix + rad + 1)
        img[y0:y1, x0:x1] += g[y0 - (iy - rad):g.shape[0] - (iy + rad
                                                             + 1 - y1),
                               x0 - (ix - rad):g.shape[1] - (ix + rad
                                                             + 1 - x1)]


def _filament(rng: np.random.Generator, img: np.ndarray,
              start: tuple, n_steps: int, amp: float,
              sigma: float = 0.9):
    """One smooth random-walk filament (microtubule-like): unit steps
    with slowly drifting heading, splatted as subpixel Gaussians."""
    y, x = start
    th = rng.uniform(0, 2 * np.pi)
    curv = rng.normal(0, 0.02)
    ys, xs = [], []
    for _ in range(n_steps):
        th += curv + rng.normal(0, 0.06)
        y += np.sin(th) * 0.7
        x += np.cos(th) * 0.7
        ys.append(y)
        xs.append(x)
    n = len(ys)
    _splat(img, ys, xs, [sigma] * n, [amp] * n, rad=3)


def _domains(rng: np.random.Generator, size: int, scale_px: float,
             amp: float, wall: float = 6.0) -> np.ndarray:
    """Sharp-walled intensity domains: band-limited noise squashed
    through a steep tanh into +-amp plateaus of ~scale_px extent with
    ~scale_px/wall-wide walls. The key recoverability property (unlike
    sub-pixel iid speckle, which binning destroys irreversibly): the
    domains survive LR binning as localizable blobs, but their SHARP
    walls do not — a trained net can re-render the wall sharpness from
    the LR context while bicubic necessarily keeps it smeared. This is
    the intra-ROI restoration problem the reference's Table-4 metric
    rewards."""
    z = _smooth_noise(rng, size, scale_px, 1.0)
    return np.tanh(z * wall) * amp


def _disks(rng: np.random.Generator, img: np.ndarray, ii: np.ndarray,
           n: int, r_lo: float, r_hi: float, amp_lo: float,
           amp_hi: float, sign_p: float = 0.5):
    """Sharp-edged organelle disks (vesicles/granules) at interior
    positions: radius r_lo..r_hi px, ~1.5 px edge, bright or dark
    (sign_p = P[bright]). Disk bodies survive binning; their edges are
    the learnable content."""
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    idx = rng.integers(0, len(ii), n)
    for j in range(n):
        cy = ii[idx[j], 0] + rng.uniform(-0.5, 0.5)
        cx = ii[idx[j], 1] + rng.uniform(-0.5, 0.5)
        r0 = rng.uniform(r_lo, r_hi)
        a = rng.uniform(amp_lo, amp_hi)
        if rng.uniform() > sign_p:
            a = -a
        w = int(np.ceil(r0 + 3))
        y0, y1 = max(0, int(cy) - w), min(size, int(cy) + w + 1)
        x0, x1 = max(0, int(cx) - w), min(size, int(cx) + w + 1)
        d = np.sqrt((yy[y0:y1, x0:x1] - cy) ** 2
                    + (xx[y0:y1, x0:x1] - cx) ** 2)
        img[y0:y1, x0:x1] += a * np.clip((r0 - d) / 1.5 + 0.5, 0.0, 1.0)


def rich_cell_tile(rng: np.random.Generator, size: int = 512,
                   cell: str = 'CELL0',
                   texture: str = 'v1') -> np.ndarray:
    """Structured fluorescence-like tile with *learnable high-frequency
    content* — the synthetic stand-in for the real SR-CACO-2 markers
    (reference doc/nutrition-label.png: CELL0=Survivin puncta,
    CELL1=E-cadherin membrane + GFP-tubulin filaments,
    CELL2=mCherry-H2B nuclei).

    Unlike the smooth Gaussian blobs of `_cell_image` (for which
    bicubic interpolation is near-optimal, so no SR net can show a
    margin), these tiles carry sharp cell boundaries, 1-3 px membrane
    rims, ~1 px filaments, 1-2 px puncta and fine chromatin texture:
    consistent statistics a trained network can learn to restore from
    a degraded LR while bicubic cannot.

    texture='v2' (round 4, VERDICT r3 #3): the *interiors* additionally
    carry structured sub-diffraction content — tanh-sharpened speckle
    instead of part of the iid smooth noise, dense 0.8-1.3 px puncta in
    every marker, radial membrane striations (CELL1), sharp chromatin
    speckle (CELL2) — so the Otsu-ROI (which covers the bright cell
    support) holds learnable restoration headroom, the axis the
    reference's Table 4 measures (utils_trainer.py:874). v1 rng draws
    are preserved bit-exactly."""
    rel = size / 512.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size), 2.0, np.float32)
    interior_total = np.zeros((size, size), bool)

    n_cells = max(3, int(rng.integers(9, 15) * rel * rel))
    for _ in range(n_cells):
        cy = rng.uniform(0.05 * size, 0.95 * size)
        cx = rng.uniform(0.05 * size, 0.95 * size)
        a = rng.uniform(35, 95) * max(rel, 0.12)
        b = a * rng.uniform(0.55, 1.0)
        th = rng.uniform(0, np.pi)
        ca, sa = np.cos(th), np.sin(th)
        dy = (yy - cy) * ca + (xx - cx) * sa
        dx = -(yy - cy) * sa + (xx - cx) * ca
        # irregular boundary: low-order angular wobble of the radius
        phi = np.arctan2(dy / a, dx / b)
        wob = np.ones_like(phi)
        for k in range(2, 6):
            wob += rng.uniform(0, 0.10) * np.cos(
                k * phi + rng.uniform(0, 2 * np.pi))
        d = np.sqrt((dy / a) ** 2 + (dx / b) ** 2) / wob
        interior = d < 1.0
        interior_total |= interior
        # flat-ish interior with a steep (sharp) edge falloff
        base = rng.uniform(25, 90)
        env = base * np.clip((1.0 - d) * 8.0, 0.0, 1.0)
        # granular intracellular texture; v2 swaps the fine iid
        # component (irrecoverable — a floor common to every method)
        # for sharp-walled domains at >= LR-pixel scale whose WALLS are
        # the learnable content
        if texture == 'v2':
            tex = (_domains(rng, size, 9.0, base * 0.30)
                   + _smooth_noise(rng, size, 7.0, base * 0.08))
        else:
            tex = (_smooth_noise(rng, size, 2.5, base * 0.25)
                   + _smooth_noise(rng, size, 7.0, base * 0.18))
        img += np.where(interior, env + tex, 0.0)
        if cell == 'CELL1':
            # bright membrane rim, 1-3 px
            w = rng.uniform(0.015, 0.04)
            rim = np.exp(-((d - 1.0) / w) ** 2) * rng.uniform(70, 160)
            img += rim
            if texture == 'v2':
                # sharp radial striations inside the rim (junction
                # bands, ~9 px period, square-ish walls): bands survive
                # binning, their sharp walls are the learnable content
                period = rng.uniform(8.0, 12.0)
                phase = rng.uniform(0, 2 * np.pi)
                band = ((d > 0.70) & (d < 0.98)).astype(np.float32)
                stri = np.tanh(np.cos(2 * np.pi * d * min(a, b)
                                      / period + phase) * 4.0)
                img += band * (stri * 0.5 + 0.5) * base * 0.5
        if cell == 'CELL2':
            # nucleus: smaller sharp ellipse + fine chromatin texture
            dn = np.sqrt((dy / (a * 0.45)) ** 2 + (dx / (b * 0.45)) ** 2)
            nuc = dn < 1.0
            amp_n = rng.uniform(60, 150)
            chro = _domains(rng, size, 6.0, amp_n * 0.35) \
                if texture == 'v2' else \
                _smooth_noise(rng, size, 1.8, amp_n * 0.30)
            img += np.where(
                nuc, amp_n * np.clip((1.0 - dn) * 10.0, 0.0, 1.0)
                + chro, 0.0)

    ii = np.argwhere(interior_total)
    if len(ii) == 0:
        ii = np.array([[size // 2, size // 2]])
    if cell in ('CELL0', 'CELL2'):
        # puncta (Survivin-like); CELL2 gets a sparser sprinkle
        n_p = int((300 if cell == 'CELL0' else 60) * rel * rel)
        n_p = max(8, n_p)
        idx = rng.integers(0, len(ii), n_p)
        ys = ii[idx, 0] + rng.uniform(-0.5, 0.5, n_p)
        xs = ii[idx, 1] + rng.uniform(-0.5, 0.5, n_p)
        _splat(img, ys, xs, rng.uniform(0.7, 1.6, n_p),
               rng.uniform(50, 200, n_p), rad=4)
    if texture == 'v2':
        # sharp-edged organelle disks in EVERY marker's interiors
        # (vesicles/granules, radius 3-7 px): disk bodies survive
        # binning as localizable blobs, their 1.5 px edges are the
        # learnable intra-ROI content
        n_d = max(8, int(120 * rel * rel))
        _disks(rng, img, ii, n_d, 3.0, 7.0, 25.0, 80.0, sign_p=0.6)
    if cell == 'CELL1':
        # tubulin-like filaments seeded inside cells
        n_f = max(3, int(14 * rel * rel))
        for _ in range(n_f):
            p = ii[rng.integers(0, len(ii))]
            # keep high > low for tiles smaller than ~128 px, where
            # 350*rel would drop to/below the 80-step minimum
            hi_steps = max(81, int(350 * max(rel, 0.2)))
            _filament(rng, img, (float(p[0]), float(p[1])),
                      n_steps=int(rng.integers(80, hi_steps)),
                      amp=rng.uniform(25, 70))
    img += rng.normal(0, 1.0, img.shape)  # faint camera background
    return np.clip(img, 0, 255).astype(np.uint8)


def degrade_lr(hr: np.ndarray, scale: int, rng: np.random.Generator,
               read_sigma: float = 1.5,
               photon_coef: float = 4.0) -> np.ndarray:
    """Microscope-like LR acquisition: block-mean binning (sensor
    integration) + signal-dependent shot noise + read noise. The noise
    is on the *LR observation only* (the HR target stays clean), so a
    trained network can learn to suppress it while bicubic upsampling
    necessarily keeps it — the same mechanism that gives trained nets
    their published margin over bicubic on the real (noisy) low-res
    acquisitions."""
    h, w = hr.shape
    lo = hr.astype(np.float32).reshape(
        h // scale, scale, w // scale, scale).mean((1, 3))
    sigma = read_sigma + photon_coef * np.sqrt(lo / 255.0)
    lo = lo + rng.normal(0, 1.0, lo.shape) * sigma
    return np.clip(lo, 0, 255).astype(np.uint8)


def _cell_image(rng: np.random.Generator, size: int = 512,
                n_blobs=(6, 18)) -> np.ndarray:
    """One synthetic fluorescence tile: gaussian blobs + faint background
    noise, uint8 HxW. Blob count and size scale with the tile area so
    small test tiles do not saturate."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.zeros((size, size), np.float32)
    rel = size / 512.0
    lo = max(1, int(n_blobs[0] * rel * rel * 4))
    hi = max(lo + 1, int(n_blobs[1] * rel * rel * 4))
    for _ in range(int(rng.integers(lo, hi))):
        cy = rng.uniform(0.1 * size, 0.9 * size)
        cx = rng.uniform(0.1 * size, 0.9 * size)
        sy = rng.uniform(6, 60) * max(rel, 0.15)
        sx = sy * rng.uniform(0.6, 1.6)
        amp = rng.uniform(40, 230)
        ang = rng.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        dy = (yy - cy) * ca + (xx - cx) * sa
        dx = -(yy - cy) * sa + (xx - cx) * ca
        img += amp * np.exp(-(dy ** 2 / (2 * sy ** 2)
                              + dx ** 2 / (2 * sx ** 2)))
    img += rng.normal(2.0, 1.5, img.shape)  # dark background noise
    return np.clip(img, 0, 255).astype(np.uint8)


def _downscale_with_noise(hr: np.ndarray, scale: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Simulate the real microscope LR: block-mean downscale + photon-ish
    noise (distinct from the framework's own LR synthesis so real-LR and
    interpolated-LR paths are distinguishable in tests)."""
    h, w = hr.shape
    lo = hr.reshape(h // scale, scale, w // scale, scale).mean((1, 3))
    lo = lo + rng.normal(0, 3.0, lo.shape) * (lo > 6)
    return np.clip(lo, 0, 255).astype(np.uint8)


def make_synthetic_dataset(root: str, scale: int = 2, cell: str = 'CELL0',
                           n_train: int = 16, n_val: int = 4,
                           n_test: int = 4, size: int = 512,
                           seed: int = 0,
                           style: str = 'blobs') -> List[str]:
    """Write a miniature caco2-layout dataset. Returns the three dataset
    names (train, val, test). `root` serves as both data_root and
    splits_root. style='blobs' keeps the fast smooth-blob tiles (unit
    tests); style='rich' uses `rich_cell_tile` + `degrade_lr` —
    structured tiles with learnable high-frequency content, the setting
    for quality/convergence runs."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, 'caco2')
    hr_dir = os.path.join(img_dir, 'hr_div_1')
    lr_dir = os.path.join(img_dir, f'hr_div_{scale}')
    os.makedirs(hr_dir, exist_ok=True)
    os.makedirs(lr_dir, exist_ok=True)

    names = []
    counter = 0
    for split, n in ((constants.TRAINSET, n_train),
                     (constants.VALIDSET, n_val),
                     (constants.TESTSET, n_test)):
        ds_name = constants.caco2_name(split, scale, cell)
        names.append(ds_name)
        fold_dir = os.path.join(root, 'folds', 'super-resolution', ds_name)
        os.makedirs(fold_dir, exist_ok=True)
        lh_lines, hl_lines = [], []
        for _ in range(n):
            hi = f'tile_HighRes{size}-{counter}_{cell}.tif'
            lo = f'tile_LowRes{size // scale}-{counter}_{cell}.tif'
            if style in ('rich', 'rich_v2'):
                hr = rich_cell_tile(rng, size, cell,
                                    texture='v2' if style == 'rich_v2'
                                    else 'v1')
                lr = degrade_lr(hr, scale, rng)
            else:
                hr = _cell_image(rng, size)
                lr = _downscale_with_noise(hr, scale, rng)
            dio.imsave(hr, os.path.join(hr_dir, hi))
            dio.imsave(lr, os.path.join(lr_dir, lo))
            h_rel = f'hr_div_1/{hi}'
            l_rel = f'hr_div_{scale}/{lo}'
            lh_lines.append(f'{l_rel},{h_rel}')
            hl_lines.append(f'{h_rel},{l_rel}')
            counter += 1
        with open(os.path.join(fold_dir, 'l_h.txt'), 'w') as f:
            f.write('\n'.join(lh_lines) + '\n')
        with open(os.path.join(fold_dir, 'h_l.txt'), 'w') as f:
            f.write('\n'.join(hl_lines) + '\n')
    return names
