"""Packed-array dataset staging for the device-resident pipeline (port of
srcaco2_tpu/data/dataset.py).

Every image of a split is decoded once on the host into packed uint8
arrays; `stage(device)` puts them on the card once, and every per-step
transform (crop, augment, normalize) runs there (data/pipeline.py).

LR synthesis (the `use_interpolated_low` option, or a dataset without
LR files): torch-bicubic downscale of the HR (no antialias), clamped,
truncated to uint8; for caco2, N(v, sigma^2) noise inside ROI = (v >=
th), clamped and truncated again. JAX draws that noise from
`fold_in(key(seed), sample index)`; the port draws it from a
torch.Generator seeded from (seed, sample index), so the noisy LR is
not JAX's (the noiseless one is).

The reconstruct task (task=reconstruct, JAX's dataset.py:215-243) maps
each split onto the LR grid at scale 1: with reconstruct_input=fake the
pair is (the LR through `blur_true_lr`'s chain -> the LR itself); with
real (eval only) input and target are both the HR downscaled without
noise.
"""
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import folds as F
from srcaco2_tpu_torch.data import io as dio
from srcaco2_tpu_torch.ops.resize import imresize_matlab, interpolate
from srcaco2_tpu_torch.utils.reproducibility import derived_seed

SEP = '+'


def ds_dir(ds_name: str) -> str:
    """Dataset directory under data_root."""
    for prefix in ('caco2', 'biosr'):
        if ds_name.startswith(prefix):
            return prefix
    raise NotImplementedError(ds_name)


def is_caco2(path: str) -> bool:
    return 'caco2' in path.lower()


@dataclass
class SRDataset:
    """One split of one dataset, staged as packed arrays."""
    name: str
    phase: str                      # train | eval
    scale: int
    n_channels: int
    hr: np.ndarray                  # (N, H, W, C) uint8
    lr: np.ndarray                  # (N, h, w, C) uint8 (real or synthetic)
    ids: List[str]
    h_paths: List[str]
    l_paths: List[str]
    lr_is_real: bool = False
    # staged device copies (filled by stage())
    hr_dev: Optional[torch.Tensor] = field(default=None, repr=False)
    lr_dev: Optional[torch.Tensor] = field(default=None, repr=False)

    def __len__(self):
        return self.hr.shape[0]

    @property
    def h_size(self):
        return self.hr.shape[1]

    @property
    def l_size(self):
        return self.lr.shape[1]

    def stage(self, device):
        """Put the packed uint8 stacks on `device`, once."""
        self.hr_dev = torch.from_numpy(self.hr).to(device)
        self.lr_dev = torch.from_numpy(self.lr).to(device)
        return self


def synth_lr_from_hr(hr_u8: np.ndarray, scale: int, seed: int,
                     inter_low_th: float, inter_low_sigma: float,
                     simulate_noise: bool, batch: int = 256,
                     device='cpu') -> np.ndarray:
    """The LR stack synthesized from the HR stack, in batches on
    `device`: bicubic downscale (no antialias), clamp [0, 255], truncate
    to uint8; with `simulate_noise`, per-sample Gaussian noise inside
    the ROI, clamp, truncate."""
    n, h, w, c = hr_u8.shape
    lh, lw = h // scale, w // scale
    chunks = []
    for i in range(0, n, batch):
        x = torch.from_numpy(hr_u8[i:i + batch]).to(device)
        x = x.float().permute(0, 3, 1, 2)
        lo = torch.floor(torch.clip(interpolate(x, size=(lh, lw)),
                                    0.0, 255.0))
        if simulate_noise:
            for j in range(lo.shape[0]):
                gen = torch.Generator(device=lo.device).manual_seed(
                    derived_seed(seed, i + j))
                img = lo[j]
                roi = (img >= inter_low_th).float()
                noisy = img + inter_low_sigma * torch.randn(
                    img.shape, generator=gen, device=img.device)
                noisy = torch.clip(noisy, 0.0, 255.0)
                out = noisy * roi + (1.0 - roi) * img
                lo[j] = torch.floor(torch.clip(out, 0.0, 255.0))
        chunks.append(lo.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy())
    return np.concatenate(chunks, 0)


def blur_true_lr(lr_u8: np.ndarray, batch: int = 256) -> np.ndarray:
    """The reconstruct task's blur chain (JAX's dataset.py:blur_true_lr):
    two rounds of MATLAB-bicubic x2 then x0.5, in f32 on the host, then
    / 255. (N, h, w, C) uint8 -> (N, h, w, C) f32 in [0, 1]."""
    outs = []
    for i in range(0, lr_u8.shape[0], batch):
        x = torch.from_numpy(lr_u8[i:i + batch]).float().permute(0, 3, 1, 2)
        for _ in range(2):
            x = imresize_matlab(x, 2.0)
            x = imresize_matlab(x, 0.5)
        outs.append((x / 255.0).permute(0, 2, 3, 1).numpy())
    return np.concatenate(outs, 0)


def load_dataset(args, ds_name: str, phase: str, n: int = -1,
                 frac: float = 1.0) -> SRDataset:
    """Decode one dataset split into packed arrays (not staged).

    args needs: data_root, splits_root, scale, n_channels, myseed,
    use_interpolated_low, inter_low_th, inter_low_sigma, num_workers,
    task (reconstruct_input under task=reconstruct)."""
    split, scale, _ = constants.parse_caco2_name(ds_name)
    if scale != args['scale']:
        raise ValueError(f'{ds_name}: scale {scale}, the run has '
                         f'{args["scale"]}')
    splits_root = args['splits_root'] or args['data_root']
    l_h, _ = F.get_pairs(splits_root, ds_name)
    if frac < 1.0:
        l_h = F.subset_fraction(l_h, frac)
    if n > 0:
        l_h = l_h[:n]
    base = os.path.join(args['data_root'], ds_dir(ds_name))
    l_paths = [os.path.join(base, l.split(constants.CODE_IDENTIFIER)[0])
               for (l, _) in l_h]
    h_paths = [os.path.join(base, h.split(constants.CODE_IDENTIFIER)[0])
               for (_, h) in l_h]
    ids = [h for (_, h) in l_h]

    nch = args['n_channels']
    workers = args.get('num_workers', 8)
    hr = dio.read_image_stack(h_paths, nch, workers)

    have_real = all(os.path.isfile(p) for p in l_paths[:4]) and l_paths
    if not have_real or bool(args.get('use_interpolated_low', False)):
        lr = synth_lr_from_hr(
            hr, scale, seed=int(args.get('myseed', 0)),
            inter_low_th=float(args['inter_low_th']),
            inter_low_sigma=float(args['inter_low_sigma']),
            simulate_noise=is_caco2(base))
        lr_is_real = False
    else:
        lr = dio.read_image_stack(l_paths, nch, workers)
        lr_is_real = True
    if lr.shape[1] * scale != hr.shape[1]:
        raise ValueError(f'{ds_name}: LR {lr.shape} x{scale} is not HR '
                         f'{hr.shape}')
    if args.get('task') == constants.RECONSTRUCT:
        return _reconstruct_pair(args, ds_name, phase, hr, lr, ids,
                                 l_paths, h_paths, lr_is_real)
    return SRDataset(name=ds_name, phase=phase, scale=scale,
                     n_channels=nch, hr=hr, lr=lr, ids=ids,
                     h_paths=h_paths, l_paths=l_paths,
                     lr_is_real=lr_is_real)


def _reconstruct_pair(args, ds_name, phase, hr, lr, ids, l_paths, h_paths,
                      lr_is_real) -> SRDataset:
    """A split of the reconstruct task, at scale 1. fake (any value but
    real, as in JAX): the blurred LR -> the LR, the LR's paths on both
    sides; real: eval only, input = target = the HR downscaled without
    noise, the HR's paths."""
    nch = args['n_channels']
    if str(args.get('reconstruct_input', 'fake')) == 'real':
        if phase != constants.EVAL_PHASE:
            raise ValueError(f'{ds_name}: reconstruct_input=real is '
                             f'eval-only, not {phase}')
        h_to_l = synth_lr_from_hr(
            hr, args['scale'], seed=int(args.get('myseed', 0)),
            inter_low_th=float(args['inter_low_th']),
            inter_low_sigma=float(args['inter_low_sigma']),
            simulate_noise=False)
        return SRDataset(name=ds_name, phase=phase, scale=1, n_channels=nch,
                         hr=h_to_l, lr=h_to_l, ids=ids, h_paths=h_paths,
                         l_paths=h_paths, lr_is_real=False)
    # JAX's order: / 255 inside the chain, then * 255 and round half to
    # even, which decides the pixels that sit on a half level
    blurred = np.clip(np.round(blur_true_lr(lr) * 255.0), 0,
                      255).astype(np.uint8)
    return SRDataset(name=ds_name, phase=phase, scale=1, n_channels=nch,
                     hr=lr, lr=blurred, ids=ids, h_paths=l_paths,
                     l_paths=l_paths, lr_is_real=lr_is_real)
