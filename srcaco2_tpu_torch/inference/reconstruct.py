"""Re-evaluation and figures of reconstruct-task experiments (port of
srcaco2_tpu/inference/reconstruct.py).

`reevaluate_reconstruct` re-scores a trained reconstruct experiment with
its reconstruct_input overridden ('fake': the blurred LR -> the LR;
'real', eval only: the HR downscaled without noise on both sides; the
mapping is data/dataset.py's), beside the interpolation floor under
`<ds>_<basic_interpolation>` (the identity at scale 1: the unrestored
input), and writes the predictions under
`<exp>/inference_reconstruct/images/<variant>/<split>/<ds>/`.
`reconstruct_figure` draws input | restored | target for one sample.
The model is the one the experiment's test used
(super_res.eval_model).
"""
import os
from typing import Dict, Optional

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.data.dataset import load_dataset
from srcaco2_tpu_torch.inference.super_res import (  # noqa: F401
    comparison_figure, eval_model, load_exp, noise_study, reevaluate,
    split_names)
from srcaco2_tpu_torch.ops import metrics as M
from srcaco2_tpu_torch.utils.logger import DLLogger

__all__ = ['load_exp', 'reevaluate', 'noise_study', 'comparison_figure',
           'reevaluate_reconstruct', 'reconstruct_figure']


def _reconstruct_exp(exp_path: str, reconstruct_input, device):
    model, args = eval_model(exp_path, device)
    if args.get('task') != constants.RECONSTRUCT:
        raise ValueError(f'{exp_path}: task {args.get("task")!r}, not '
                         f'{constants.RECONSTRUCT!r}')
    if reconstruct_input is not None:
        args['reconstruct_input'] = reconstruct_input
    return model, args


def reevaluate_reconstruct(exp_path: str,
                           reconstruct_input: Optional[str] = None,
                           split: str = constants.TESTSET, n: int = -1,
                           save_images: bool = True, device=None) -> Dict:
    """{ds_name: perf, f'{ds_name}_{basic_interpolation}': the floor's
    perf} over the first n images (all: -1) of each dataset of `split`
    (fast_eval's perf dicts); with save_images the predictions go to the
    variant's image directory."""
    from srcaco2_tpu_torch.train.evaluator import (fast_eval,
                                                   make_interpolate_forward)
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    model, args = _reconstruct_exp(exp_path, reconstruct_input, device)
    variant = str(args.get('reconstruct_input', 'fake'))
    interp_mode = args.get('basic_interpolation', constants.INTER_BICUBIC)
    fwd = make_eval_forward(model, args['netG']['net_type'],
                            int(args['scale']), netG=args['netG'])
    outd = os.path.join(exp_path, 'inference_reconstruct')
    bsize = int(args['eval_bsize'])
    out = {}
    for name in split_names(args, split):
        ds = load_dataset(args, name, constants.EVAL_PHASE, n=n)
        img_dir = None
        if save_images:
            img_dir = os.path.join(outd, 'images', variant, split,
                                   name.replace('/', '_'))
            os.makedirs(img_dir, exist_ok=True)
        perf = fast_eval(fwd, None, ds, args, bsize, split,
                         save_img_dir=img_dir)
        out[name] = perf
        bperf = fast_eval(make_interpolate_forward(ds.scale, interp_mode),
                          None, ds, args, bsize, split)
        out[f'{name}_{interp_mode}'] = bperf
        DLLogger.log(
            f'[reconstruct/{variant}] {name}: psnr '
            f"{perf['full'][constants.PSNR_MTR]:.4f} (floor "
            f"{bperf['full'][constants.PSNR_MTR]:.4f})")
    return out


def reconstruct_figure(exp_path: str, out_path: str, sample_idx: int = 0,
                       reconstruct_input: Optional[str] = None,
                       split: str = constants.TESTSET, device=None) -> str:
    """input (degraded) | restored | target for one sample of the first
    dataset of `split`, captioned (diagnosis/visualize.restore_grid; it
    needs matplotlib). All three share the LR grid."""
    from srcaco2_tpu_torch.diagnosis.visualize import restore_grid
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    model, args = _reconstruct_exp(exp_path, reconstruct_input, device)
    name = split_names(args, split)[0]
    ds = load_dataset(args, name, constants.EVAL_PHASE,
                      n=sample_idx + 1).stage(args['device'])
    batch = P.make_eval_batch(ds.hr_dev, ds.lr_dev, torch.tensor(
        [sample_idx], device=ds.hr_dev.device))
    fwd = make_eval_forward(model, args['netG']['net_type'],
                            int(args['scale']), netG=args['netG'])
    e = fwd(None, batch)[0, 0].cpu().numpy()
    inp = M.uint8_round(batch['l_im'])[0, 0].cpu().numpy()
    trg = M.uint8_round(batch['h_im'])[0, 0].cpu().numpy()
    return restore_grid([inp, e], ['input (degraded)', 'restored'], trg,
                        out_path)
