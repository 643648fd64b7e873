"""The evaluation engine (port of srcaco2_tpu/train/evaluator.py):
the metric pass, `fast_eval` over a dataset split, and the bicubic
baseline's forward.

The metric pass computes the full-image metrics and, with `over_roi`,
the ROI metrics marginalized over the thresholds, on a batch of
uint8-rounded [0, 255] NCHW predictions and targets. `fast_eval` runs a
split in fixed-size batches (the last one padded), stops on a
non-finite output or a non-finite or negative metric, and returns the
means and the per-image details; it can dump the first predictions as
PNG. The multi-process gather of the JAX package waits for multi-GPU
(ROADMAP.md).
"""
import functools
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.data.dataset import SRDataset
from srcaco2_tpu_torch.models.interpolate import interpolate_model
from srcaco2_tpu_torch.ops import metrics as M
from srcaco2_tpu_torch.utils.logger import DLLogger

EVAL_METRICS = [constants.PSNR_MTR, constants.PSNR_Y_MTR,
                constants.MSE_MTR, constants.NRMSE_MTR,
                constants.SSIM_MTR]


def _metrics_one_batch(e_img, h_img, border: int, over_roi: bool,
                       roi_ths):
    out = {'full': M.compute_metrics(e_img, h_img, border)}
    if over_roi:
        out['roi'] = M.compute_metrics_roi_marginal(e_img, h_img, border,
                                                    roi_ths)
    return out


@functools.lru_cache(maxsize=32)
def make_metric_fn(border: int, over_roi: bool,
                   roi_ths: tuple) -> Callable:
    """(e_img, h_img) -> {'full': {metric: (B,)}, 'roi': {...}} under
    torch.inference_mode(); cached per setting, as the JAX package
    caches its compiled program."""
    @torch.inference_mode()
    def fn(e_img, h_img):
        return _metrics_one_batch(e_img, h_img, border, over_roi, roi_ths)

    return fn


def fast_eval(forward: Callable, params, ds: SRDataset, args,
              eval_bsize: int, split: str,
              save_img_dir: Optional[str] = None,
              nbr_to_plot: int = 30,
              current_step: int = 0,
              track_evolution_img: bool = False) -> Dict:
    """Evaluate one dataset split. Returns
    {'full': {metric: mean}, 'roi': {...}, 'details': {id: {...}},
    'roi_details': {...}, 'n': N, 'time': s}. The split is staged on
    args['device'] if it is not yet."""
    t0 = time.perf_counter()
    n = len(ds)
    border = int(args['scale'])
    over_roi = bool(args.get('eval_over_roi_also', False))
    roi_ths = args.get('eval_over_roi_also_ths', constants.ROI_THRESH)
    metric_fn = make_metric_fn(border, over_roi, tuple(roi_ths))
    if ds.hr_dev is None:
        ds.stage(resolve_device(args.get('device')))
    dev = ds.hr_dev.device
    # SSIM is legitimately in [-1, 1]: an anticorrelated output of a
    # few-epoch net is negative without any corruption, so fast-sweep
    # mode (SRCACO2_FAST_SWEEP=1) demotes a finite negative metric to a
    # logged warning; a non-finite one stops the run everywhere.
    fast_sweep = os.environ.get('SRCACO2_FAST_SWEEP') == '1'

    sums = {'full': {m: 0.0 for m in EVAL_METRICS}}
    if over_roi:
        sums['roi'] = {m: 0.0 for m in EVAL_METRICS}
    details, roi_details = {}, {}
    n_plotted = 0
    for start in range(0, n, eval_bsize):
        idx = np.arange(start, min(start + eval_bsize, n))
        pad = eval_bsize - len(idx)
        idx_p = np.concatenate([idx, np.repeat(idx[-1:], pad)]) \
            if pad else idx
        batch = P.make_eval_batch(ds.hr_dev, ds.lr_dev,
                                  torch.from_numpy(idx_p).to(dev))
        e_img = forward(params, batch)
        if not bool(torch.isfinite(e_img).all()):
            DLLogger.log(f'CORRUPTED model output in eval ({ds.name}); '
                         f'aborting.')
            raise FloatingPointError('non-finite eval output')
        res = metric_fn(e_img, M.uint8_round(batch['h_im']))
        res = {scope: {m: v.double().cpu().numpy() for m, v in r.items()}
               for scope, r in res.items()}
        for scope in res:
            for m, v in res[scope].items():
                vv = v[:len(idx)]
                if not np.all(np.isfinite(vv)):
                    DLLogger.log(f'CORRUPTED metric {scope}/{m} in '
                                 f'{ds.name}: {vv}')
                    raise FloatingPointError(
                        f'non-finite metric {scope}/{m}')
                if np.any(vv < 0):
                    DLLogger.log(f'CORRUPTED metric {scope}/{m} in '
                                 f'{ds.name}: {vv}')
                    if not fast_sweep:
                        raise FloatingPointError(
                            f'non-finite/negative metric {scope}/{m}')
        for scope in sums:
            for m in EVAL_METRICS:
                sums[scope][m] += float(res[scope][m][:len(idx)].sum())
        for j, gi in enumerate(idx):
            img_id = ds.ids[gi]
            details[img_id] = {m: float(res['full'][m][j])
                               for m in EVAL_METRICS}
            if over_roi:
                roi_details[img_id] = {m: float(res['roi'][m][j])
                                       for m in EVAL_METRICS}
        if save_img_dir and n_plotted < nbr_to_plot:
            from srcaco2_tpu_torch.data.io import imsave
            e_np = e_img.cpu().numpy()
            for j, gi in enumerate(idx):
                if n_plotted >= nbr_to_plot:
                    break
                img_id = ds.ids[gi].replace('/', '_')
                if track_evolution_img:
                    path = os.path.join(save_img_dir, img_id,
                                        f'{img_id}_{current_step}.png')
                else:
                    path = os.path.join(save_img_dir, f'{img_id}.png')
                imsave(e_np[j].transpose(1, 2, 0), path)
                n_plotted += 1

    out = {'full': {m: sums['full'][m] / n for m in EVAL_METRICS},
           'details': details, 'n': n,
           'time': time.perf_counter() - t0}
    if over_roi:
        out['roi'] = {m: sums['roi'][m] / n for m in EVAL_METRICS}
        out['roi_details'] = roi_details
    return out


def make_interpolate_forward(scale: int, mode: str) -> Callable:
    """The bicubic Interpolate pseudo-model as an eval forward:
    (params (unused), batch) -> the uint8-rounded upscale in [0, 255]."""

    @torch.inference_mode()
    def fwd(params, batch):
        return M.uint8_round(interpolate_model(batch['l_im'], scale,
                                               mode)['out'])

    return fwd


def log_perf(tag: str, perf: Dict):
    f = perf['full']
    msg = (f"[{tag}] psnr {f[constants.PSNR_MTR]:.4f} dB | "
           f"ssim {f[constants.SSIM_MTR]:.4f} | "
           f"nrmse {f[constants.NRMSE_MTR]:.5f} | "
           f"mse {f[constants.MSE_MTR]:.4f} | "
           f"psnr_y {f[constants.PSNR_Y_MTR]:.4f} | "
           f"n={perf['n']} | {perf['time']:.1f}s")
    if 'roi' in perf:
        r = perf['roi']
        msg += (f"\n[{tag}/ROI] psnr {r[constants.PSNR_MTR]:.4f} dB | "
                f"ssim {r[constants.SSIM_MTR]:.4f} | "
                f"nrmse {r[constants.NRMSE_MTR]:.5f}")
    DLLogger.log(msg)
