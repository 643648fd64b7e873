"""Experiment loading, re-evaluation, the synthetic-noise study and the
comparison figure over trained experiments (port of
srcaco2_tpu/inference/super_res.py).

The port reads the experiment's config_model.yml through its own config
reader (config/yaml_io: PyYAML where it imports, JSON otherwise) and the
torch state_dict at <exp>/best-models/G-model.pt, as the port's trainer
writes them (a state_dict written from flax params by
bridge.flax_to_torch reads as well); orbax checkpoints need jax and are
not read here.

`reevaluate`, `noise_study` and `comparison_figure` evaluate the model
the experiment's own test used (`eval_model`: under amp without
amp_eval, the f32 twin of the bf16 net, as train/trainer.py and
`python -m srcaco2_tpu_torch.eval` do), so that a re-evaluation
reproduces the experiment's test rows. The JAX package's tools evaluate
`load_exp`'s model, in bf16 under amp.
"""
import os
from typing import Dict, List

import numpy as np
import torch

from srcaco2_tpu_torch import constants, exact_f32, resolve_device
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.data.dataset import SEP, load_dataset
from srcaco2_tpu_torch.ops import metrics as M
from srcaco2_tpu_torch.utils.logger import DLLogger


def _load(exp_path: str, device, amp_of):
    from srcaco2_tpu_torch.models.registry import define_g
    args = yaml_io.load(os.path.join(exp_path, 'config_model.yml'))
    args['is_train'] = False
    args['distributed'] = False
    device = resolve_device(device)
    args['device'] = str(device)
    model = define_g({**args, 'amp': amp_of(args)}, device)
    state = torch.load(os.path.join(exp_path, 'best-models', 'G-model.pt'),
                       map_location=device, weights_only=True)
    model.load_state_dict(state)
    return model, args


def load_exp(exp_path: str, device=None):
    """(model, args) of a trained experiment dir, weights loaded, on
    `device` (default cuda), computing in bf16 under the config's amp."""
    return _load(exp_path, device, lambda a: bool(a.get('amp', False)))


def eval_model(exp_path: str, device=None):
    """(model, args) as load_exp, computing as the experiment's test
    did: in bf16 only under amp with amp_eval, f32 in true f32 on the
    card (exact_f32, as the trainer sets it)."""
    model, args = _load(exp_path, device, lambda a: bool(
        a.get('amp', False) and a.get('amp_eval', False)))
    exact_f32(torch.device(args['device']))
    return model, args


def split_names(args: dict, split: str) -> List[str]:
    """The dataset names of `split`: test_dsets for the test split,
    else valid_dsets."""
    names = args['test_dsets'] if split == constants.TESTSET \
        else args['valid_dsets']
    return [s for s in str(names).split(SEP) if s]


def add_roi_noise(lr_u8: np.ndarray, sigma: float, th: float) -> np.ndarray:
    """Gaussian noise of std `sigma` inside ROI = (v >= th), from numpy's
    default_rng(0), clipped and truncated to uint8 (JAX's reevaluate)."""
    lr = lr_u8.astype(np.float32)
    rng = np.random.default_rng(0)
    noisy = lr + rng.normal(0, sigma, lr.shape) * (lr >= th)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def reevaluate(exp_path: str, split: str = constants.TESTSET,
               n: int = -1, noise_sigma: float = 0.0,
               inter_low_th: float = 7.0, device=None) -> Dict:
    """Re-evaluate one experiment on the first n images (all: -1) of each
    dataset of `split`; with noise_sigma > 0 the LR gets add_roi_noise
    first. Returns {ds_name: fast_eval's perf dict}."""
    from srcaco2_tpu_torch.train.evaluator import fast_eval
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    model, args = eval_model(exp_path, device)
    fwd = make_eval_forward(model, args['netG']['net_type'],
                            int(args['scale']), netG=args['netG'])
    out = {}
    for name in split_names(args, split):
        ds = load_dataset(args, name, constants.EVAL_PHASE, n=n)
        if noise_sigma > 0:
            ds.lr = add_roi_noise(ds.lr, noise_sigma, inter_low_th)
        perf = fast_eval(fwd, None, ds, args, int(args['eval_bsize']),
                         split)
        out[name] = perf
        DLLogger.log(f'{exp_path} {name} sigma={noise_sigma}: '
                     f"psnr {perf['full'][constants.PSNR_MTR]:.4f}")
    return out


def noise_study(exp_path: str, sigmas=(0, 5, 10, 20, 40), n: int = 8,
                device=None) -> Dict[float, Dict]:
    """The synthetic-noise robustness curve: {sigma: reevaluate(...)}."""
    return {s: reevaluate(exp_path, noise_sigma=float(s), n=n,
                          device=device) for s in sigmas}


def comparison_figure(exp_paths: List[str], out_path: str,
                      sample_idx: int = 0, split=constants.TESTSET,
                      device=None) -> str:
    """Side-by-side figure of one test image: bicubic | each experiment's
    prediction | HR, with PSNR / SSIM captions and a GIF beside it
    (diagnosis/visualize.restore_grid; it needs matplotlib, imageio and
    cv2). As in JAX, the panels come from the first test dataset
    whatever `split` says."""
    from srcaco2_tpu_torch.diagnosis.visualize import restore_grid
    from srcaco2_tpu_torch.models.interpolate import interpolate_model
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    panels, titles, hr_img = [], [], None
    for i, exp in enumerate(exp_paths):
        model, args = eval_model(exp, device)
        name = split_names(args, constants.TESTSET)[0]
        ds = load_dataset(args, name, constants.EVAL_PHASE,
                          n=sample_idx + 1).stage(args['device'])
        batch = P.make_eval_batch(ds.hr_dev, ds.lr_dev, torch.tensor(
            [sample_idx], device=ds.hr_dev.device))
        if i == 0:
            bi = interpolate_model(batch['l_im'], int(args['scale']))['out']
            panels.append(M.uint8_round(bi)[0, 0].cpu().numpy())
            titles.append('Bicubic')
            hr_img = M.uint8_round(batch['h_im'])[0, 0].cpu().numpy()
        fwd = make_eval_forward(model, args['netG']['net_type'],
                                int(args['scale']), netG=args['netG'])
        panels.append(fwd(None, batch)[0, 0].cpu().numpy())
        titles.append(args['netG']['net_type'])
    gif = os.path.splitext(out_path)[0] + '.gif'
    return restore_grid(panels, titles, hr_img, out_path, gif_path=gif)
