"""Classical-restoration baseline study: regularized Wiener
deconvolution of bicubic-upsampled LR images (port of
srcaco2_tpu/diagnosis/restore.py).

Reference analog: dlib/diagnosis/restore.py — bicubic-upsamples each
LR cell image to the HR size, applies skimage ``restoration.wiener``
with a 5x5 box PSF at balances [1e-3, 1e-2, 1e-1, 1.0], and writes
per-image panels against the HR target (``process_scale`` :539-582,
``compare`` :494-532). The study also SCORES every balance through the
standard eval protocol (``fast_eval``: uint8 rounding, border=scale
crop, ROI threshold marginalization), so the classical baseline becomes
a row comparable to the bicubic floor and the trained nets.

skimage's ``wiener(img, psf, balance)`` is a direct regularized inverse
filter in Fourier space (data term ``|Y - HX|^2`` plus
``balance * |L X|^2`` with a Laplacian regularizer). The port computes
the closed form with ``torch.fft`` (cuFFT on the card), in f32, on the
batch's device. The JAX package runs the same estimator as DFT matmuls
because its TPU backend has no FFT; the two agree to f32 rounding
(tests/test_torch_restore.py states the tolerance).

    python -m srcaco2_tpu_torch.diagnosis.restore --data_root D \\
        --scale 2 [--cell CELL0] [--out_dir OUT] [--device cpu]
"""
import argparse
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from srcaco2_tpu_torch import constants

#: the reference study's regularization sweep (restore.py:563)
DEFAULT_BALANCES = (1e-3, 1e-2, 1e-1, 1.0)


def _centered_otf(kernel: np.ndarray, shape) -> np.ndarray:
    """Optical transfer function of a small centered kernel on an
    (H, W) grid: zero-pad, roll so the kernel center sits at the
    origin, FFT (numpy, float64)."""
    kh, kw = kernel.shape
    h, w = shape
    pad = np.zeros((h, w), np.float64)
    pad[:kh, :kw] = kernel
    pad = np.roll(pad, (-(kh // 2), -(kw // 2)), axis=(0, 1))
    return np.fft.fft2(pad)


def _laplacian_otf(shape) -> np.ndarray:
    """OTF of the discrete Laplacian — the default regularizer of the
    reference's skimage wiener call (restoration.wiener(reg=None))."""
    lap = np.array([[0., -1., 0.], [-1., 4., -1.], [0., -1., 0.]])
    return _centered_otf(lap, shape)


def wiener_gain(psf: np.ndarray, balance: float, shape) -> np.ndarray:
    """conj(H) / (|H|^2 + balance * |L|^2) on an (H, W) grid, float64
    complex; Hermitian, so its first W // 2 + 1 columns are the gain of
    a real FFT."""
    otf = _centered_otf(np.asarray(psf, np.float64), shape)
    reg = _laplacian_otf(shape)
    return np.conj(otf) / (np.abs(otf) ** 2 + balance * np.abs(reg) ** 2)


def wiener_filter(img: torch.Tensor, psf: np.ndarray,
                  balance: float, gain: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Closed-form regularized Wiener deconvolution of a single-channel
    image (..., H, W) in [0, 1], in f32 on its device:

        X = conj(H) Y / (|H|^2 + balance * |L|^2)

    with H the PSF transfer function and L the Laplacian regularizer —
    the same estimator skimage's ``restoration.wiener`` evaluates
    (its ``balance`` knob trades data fit vs. smoothness). `gain` is the
    real-FFT gain (wiener_gain's first W // 2 + 1 columns, complex64 on
    img's device) when the caller keeps it across calls."""
    h, w = img.shape[-2], img.shape[-1]
    if gain is None:
        gain = torch.from_numpy(
            wiener_gain(psf, balance, (h, w))[:, :w // 2 + 1]
            .astype(np.complex64)).to(img.device)
    y = torch.fft.rfft2(img.to(torch.float32))
    return torch.fft.irfft2(y * gain, s=(h, w))


def box_psf(size: int = 5) -> np.ndarray:
    """The reference study's PSF model: a size x size box blur
    (restore.py:560 ``np.ones((5, 5)) / 25``)."""
    return np.ones((size, size), np.float64) / float(size * size)


def make_wiener_forward(scale: int, balance: float,
                        psf_size: int = 5):
    """fast_eval-compatible forward: bicubic-upsample the LR batch
    (the Interpolate baseline path) then Wiener-deconvolve the result
    — the reference's interp->wiener chain (restore.py:556-566). The
    gain is computed once per image size and device."""
    from srcaco2_tpu_torch.models.interpolate import interpolate_model
    from srcaco2_tpu_torch.ops import metrics as M
    psf = box_psf(psf_size)
    gains = {}

    @torch.inference_mode()
    def fwd(params, batch):
        up = interpolate_model(batch['l_im'], scale, 'bicubic')['out']
        h, w = up.shape[-2], up.shape[-1]
        key = (h, w, str(up.device))
        if key not in gains:
            gains[key] = torch.from_numpy(
                wiener_gain(psf, balance, (h, w))[:, :w // 2 + 1]
                .astype(np.complex64)).to(up.device)
        out = wiener_filter(up, psf, balance, gains[key])
        return M.uint8_round(torch.clip(out, 0.0, 1.0))

    return fwd


def wiener_study(data_root: str, splits_root: str, scale: int,
                 cell: str,
                 balances: Iterable[float] = DEFAULT_BALANCES,
                 psf_size: int = 5, n: int = -1,
                 out_dir: Optional[str] = None,
                 n_panels: int = 2, device=None) -> Dict:
    """Score the Wiener sweep on a test split through the standard
    metric stack, on `device` (default the card). Returns
    {'bicubic': perf, balance: perf, ...} where each perf is a fast_eval
    dict ({'full': .., 'roi': ..}); when ``out_dir`` is given, also
    writes a summary yaml and, where matplotlib imports, the
    reference-style per-image panel strips (interp | wiener@balances |
    HR)."""
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.diagnosis.parity import eval_args
    from srcaco2_tpu_torch.diagnosis.visualize import has_matplotlib
    from srcaco2_tpu_torch.train.evaluator import (fast_eval,
                                                   make_interpolate_forward)
    args = eval_args(data_root, splits_root, scale, device)
    name = constants.caco2_name(constants.TESTSET, scale, cell)
    ds = load_dataset(args, name, constants.EVAL_PHASE, n=n)
    ds.stage(torch.device(args['device']))

    out: Dict = {}
    fwd = make_interpolate_forward(scale, constants.INTER_BICUBIC)
    out['bicubic'] = fast_eval(fwd, None, ds, args, 8,
                               constants.TESTSET)
    for b in balances:
        fwd = make_wiener_forward(scale, b, psf_size)
        out[float(b)] = fast_eval(fwd, None, ds, args, 8,
                                  constants.TESTSET)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        _write_summary(out, os.path.join(out_dir, 'wiener_study.yaml'))
        if has_matplotlib():
            _write_panels(ds, scale, list(balances), psf_size, out_dir,
                          n_panels, torch.device(args['device']))
    return out


def _write_panels(ds, scale: int, balances: Sequence[float],
                  psf_size: int, out_dir: str, n_panels: int,
                  device) -> None:
    """Reference-style panel strips: Interpolated | wiener@b... | HR
    with per-panel PSNR/SSIM captions (restore.py emits these one
    image per file; a strip reads easier and costs one figure)."""
    from srcaco2_tpu_torch.diagnosis.visualize import restore_grid
    from srcaco2_tpu_torch.models.interpolate import interpolate_model
    psf = box_psf(psf_size)
    for i in range(min(n_panels, len(ds))):
        # (h, w, C) uint8 -> (1, C, h, w) [0, 1]
        l_im = torch.from_numpy(
            ds.lr[i].astype(np.float32) / 255.0).permute(2, 0, 1)[None]
        up = interpolate_model(l_im.to(device), scale, 'bicubic')['out']
        panels = [up[0, 0].cpu().numpy() * 255.0]
        titles = ['Interpolated']
        for b in balances:
            w = wiener_filter(up, psf, b)
            panels.append(np.clip(w[0, 0].cpu().numpy(), 0.0, 1.0)
                          * 255.0)
            titles.append(f'wiener {b:g}')
        hr = ds.hr[i][..., 0].astype(np.float32)
        # ids embed fold subpaths ('hr_div_1/...'); flatten for the
        # panel filename
        tag = ds.ids[i].replace(os.sep, '_')
        restore_grid(panels, titles, hr,
                     os.path.join(out_dir, f'wiener_{tag}.png'))


def _write_summary(out: Dict, path: str) -> None:
    from srcaco2_tpu_torch.config import yaml_io
    slim = {}
    for k, perf in out.items():
        slim[k] = {'full': {m: float(v)
                            for m, v in perf['full'].items()},
                   'roi': {m: float(v)
                           for m, v in perf.get('roi', {}).items()}}
    if yaml_io.yaml is None:
        # JSON has str keys only: the balances are written as their
        # repr, as YAML writes a float key
        slim = {str(k): v for k, v in slim.items()}
    yaml_io.dump(slim, path)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='srcaco2_tpu_torch.diagnosis.restore',
        description='Wiener classical-restoration baseline study')
    ap.add_argument('--data_root', required=True)
    ap.add_argument('--splits_root', default=None)
    ap.add_argument('--scale', type=int, required=True)
    ap.add_argument('--cell', default='CELL0')
    ap.add_argument('--balances', type=float, nargs='+',
                    default=list(DEFAULT_BALANCES))
    ap.add_argument('--psf_size', type=int, default=5)
    ap.add_argument('--n', type=int, default=-1)
    ap.add_argument('--out_dir', default=None)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ns = ap.parse_args(argv)
    res = wiener_study(ns.data_root, ns.splits_root or ns.data_root,
                       ns.scale, ns.cell, ns.balances, ns.psf_size,
                       ns.n, ns.out_dir, device=ns.device)
    for k, perf in res.items():
        tag = k if isinstance(k, str) else f'balance={k:g}'
        f = perf['full']
        print(f"[{tag}] psnr {f[constants.PSNR_MTR]:.4f} "
              f"ssim {f[constants.SSIM_MTR]:.4f} "
              f"| roi psnr {perf['roi'][constants.PSNR_MTR]:.4f}")
    return res


if __name__ == '__main__':
    main()
