"""Evaluation's metric pass (port of srcaco2_tpu/train/evaluator.py:
_metrics_one_batch and make_metric_fn).

One call computes the full-image metrics and, with `over_roi`, the ROI
metrics marginalized over the thresholds, on a batch of uint8-rounded
[0, 255] NCHW predictions and targets. `fast_eval` (the split loop over
an SRDataset, the per-image details, the prediction dumps) waits for the
dataset port.
"""
import functools
from typing import Callable

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.ops import metrics as M

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
