"""Device-resident input pipeline: the per-step batch assembly (port of
srcaco2_tpu/data/pipeline.py).

The uint8 image stacks live on the device and every per-step transform
runs there: the patch-origin draw, the paired crops (HR at (x0, y0), LR
at (x0 // s, y0 // s), keeping the reference's up-to-(s-1)-pixel
misalignment unless `aligned_crops`), the joint 8-way dihedral augment,
and the uint8-quantized bicubic `l_to_h` of the LR crop.

JAX draws from `fold_in` streams that torch cannot reproduce, so the
batch is built in two parts: `draw` takes the origins and dihedral
modes from an explicit torch.Generator, and `assemble` is deterministic
given them (tests feed it JAX's own draws).

Ported: uniform patch sampling (the default) and aligned crops. Not
ported (they raise NotImplementedError; see ROADMAP.md): the LR-only
local augmentations (da_blur, da_dot_bin_noise, da_add_gaus_noise), ROI
and EDT sampling, and per-pixel inverse-color-frequency weights (ppiw).
"""
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data.transforms import dihedral
from srcaco2_tpu_torch.ops.resize import resize2d


@dataclass(frozen=True)
class PipeConfig:
    scale: int
    h_size: int                     # HR patch size
    n_channels: int = 1
    sample_tr_patch: str = constants.SAMPLE_UNIF
    th_style: str = constants.TH_AUTO
    th_fix: float = 0.0
    # local augs
    da_blur: bool = False
    da_blur_prob: float = 0.5
    da_blur_area: float = 0.3
    da_blur_sigma: float = 1.0
    da_dot_bin_noise: bool = False
    da_dot_bin_noise_prob: float = 0.5
    da_dot_bin_noise_area: float = 0.3
    da_dot_bin_noise_p: float = 0.5
    da_add_gaus_noise: bool = False
    da_add_gaus_noise_prob: float = 0.5
    da_add_gaus_noise_area: float = 0.3
    da_add_gaus_noise_std: float = 0.03
    ppiw: bool = False
    # False: the reference's paired crop, the LR origin the floor
    # division of the HR origin (pairs misaligned by up to scale-1 HR
    # pixels); True snaps the HR origin to the LR grid.
    aligned_crops: bool = False

    @property
    def l_size(self):
        return self.h_size // self.scale


def from_args(args: dict) -> PipeConfig:
    return PipeConfig(
        scale=args['scale'], h_size=args['h_size'],
        n_channels=args['n_channels'],
        sample_tr_patch=args['sample_tr_patch'],
        th_style=args['sample_tr_patch_th_style'],
        th_fix=float(args['sample_tr_patch_th'])
        if args['sample_tr_patch_th_style'] == constants.TH_FIX else 0.0,
        da_blur=args['da_blur'], da_blur_prob=args['da_blur_prob'],
        da_blur_area=args['da_blur_area'],
        da_blur_sigma=args['da_blur_sigma'],
        da_dot_bin_noise=args['da_dot_bin_noise'],
        da_dot_bin_noise_prob=args['da_dot_bin_noise_prob'],
        da_dot_bin_noise_area=args['da_dot_bin_noise_area'],
        da_dot_bin_noise_p=args['da_dot_bin_noise_p'],
        da_add_gaus_noise=args['da_add_gaus_noise'],
        da_add_gaus_noise_prob=args['da_add_gaus_noise_prob'],
        da_add_gaus_noise_area=args['da_add_gaus_noise_area'],
        da_add_gaus_noise_std=args['da_add_gaus_noise_std'],
        ppiw=args['ppiw'],
        aligned_crops=bool(args.get('train_aligned_crops', False)))


def check_ported(cfg: PipeConfig):
    """Raise for the pipeline options the port does not have yet."""
    todo = []
    if cfg.sample_tr_patch != constants.SAMPLE_UNIF:
        todo.append(f'{cfg.sample_tr_patch} patch sampling')
    for name in ('da_blur', 'da_dot_bin_noise', 'da_add_gaus_noise'):
        if getattr(cfg, name) and getattr(cfg, f'{name}_area') > 0:
            todo.append(name)
    if cfg.ppiw:
        todo.append('ppiw')
    if todo:
        raise NotImplementedError(
            f'{", ".join(todo)}: not ported yet (see ROADMAP.md)')


def _u8_quant(x01: torch.Tensor) -> torch.Tensor:
    """Round to the uint8 grid in [0,1] (the reference materializes
    intermediate images as uint8)."""
    return torch.round(torch.clip(x01, 0.0, 1.0) * 255.0) / 255.0


class Draws(NamedTuple):
    """A batch's random choices, (B,) int64 each: the HR patch origin
    (row x0, column y0) and the dihedral mode in [0, 8); and `lsh`, the
    CPU generator of the step's hash rotations (NLSN,
    utils/reproducibility.lsh_generator; None: the model's own)."""
    x0: torch.Tensor
    y0: torch.Tensor
    mode: torch.Tensor
    lsh: Optional[torch.Generator] = None


def draw(gen: torch.Generator, n: int, cfg: PipeConfig,
         hr_hw) -> Draws:
    """Uniform patch origins and dihedral modes for n samples from
    `gen`, on the generator's device. Both origins range over the HR
    height, as the JAX pipeline draws them (pipeline.py:256-258)."""
    check_ported(cfg)
    hi = max(0, int(hr_hw[0]) - cfg.h_size) + 1

    def randint(high):
        return torch.randint(0, high, (n,), generator=gen,
                             device=gen.device)
    return Draws(randint(hi), randint(hi), randint(8))


@functools.lru_cache(maxsize=16)
def _dihedral_sources(side: int, device: str) -> torch.Tensor:
    """(8, side*side): for each mode, the flat source pixel of every
    output pixel of the dihedral transform of a square patch."""
    grid = torch.arange(side * side).reshape(side, side, 1)
    return torch.stack([dihedral(grid, m).reshape(-1)
                        for m in range(8)]).to(device)


def _crop_dihedral(stack_u8, idxs, r0, c0, side, mode):
    """(B, C, side, side) f32 in [0, 1]: per sample the side x side crop
    of stack_u8[idxs] at (r0, c0) (clamped into the image, as
    dynamic_slice clamps), dihedral-transformed by its mode; one
    gather."""
    _, h, w, _ = stack_u8.shape
    r0 = r0.clamp(0, h - side)
    c0 = c0.clamp(0, w - side)
    src = _dihedral_sources(side, str(stack_u8.device))[mode]
    rows = r0[:, None] + src // side
    cols = c0[:, None] + src % side
    px = stack_u8[idxs.long()[:, None], rows, cols]       # (B, s*s, C)
    px = px.reshape(-1, side, side, px.shape[-1]).permute(0, 3, 1, 2)
    return px.float() / 255.0


def assemble(hr_u8: torch.Tensor, lr_u8: torch.Tensor, idxs: torch.Tensor,
             draws: Draws, cfg: PipeConfig) -> dict:
    """One train batch from its draws, on the stacks' device.

    hr_u8: (N, H, W, C) uint8; lr_u8: (N, h, w, C) uint8; idxs: (B,) int.
    Returns NCHW f32 in [0, 1]: l_im (B,C,ls,ls), h_im (B,C,hs,hs),
    l_to_h_img and l_to_h_img_aug (B,C,hs,hs)."""
    check_ported(cfg)
    dev = hr_u8.device
    if any(t.device != dev for t in (lr_u8, idxs, *draws[:3])):
        raise ValueError(f'stacks, indices and draws must all be on {dev}')
    sf, hs, ls = cfg.scale, cfg.h_size, cfg.l_size
    x0, y0 = draws.x0, draws.y0
    xl, yl = x0 // sf, y0 // sf
    if cfg.aligned_crops:
        x0, y0 = xl * sf, yl * sf
    h_im = _crop_dihedral(hr_u8, idxs, x0, y0, hs, draws.mode)
    l_im = _crop_dihedral(lr_u8, idxs, xl, yl, ls, draws.mode)
    l_im = torch.clip(l_im, 0.0, 1.0)
    l2h = _u8_quant(resize2d(l_im, (hs, hs)))
    return {'l_im': l_im, 'h_im': h_im, 'l_to_h_img': l2h,
            'l_to_h_img_aug': l2h}


def make_train_batch(hr_u8: torch.Tensor, lr_u8: torch.Tensor,
                     idxs: torch.Tensor, gen: torch.Generator,
                     cfg: PipeConfig) -> dict:
    """assemble(draw(...)): a train batch with fresh draws from gen."""
    return assemble(hr_u8, lr_u8, idxs,
                    draw(gen, idxs.shape[0], cfg, hr_u8.shape[1:3]), cfg)


def make_eval_batch(hr_u8: torch.Tensor, lr_u8: torch.Tensor,
                    idxs: torch.Tensor) -> dict:
    """Full-image eval batch: NCHW f32 [0,1] l_im / h_im / l_to_h."""
    idxs = idxs.long()
    hr = hr_u8[idxs].float().permute(0, 3, 1, 2) / 255.0
    lr = lr_u8[idxs].float().permute(0, 3, 1, 2)
    l2h = resize2d(lr, (hr.shape[2], hr.shape[3]))
    l2h = torch.round(torch.clip(l2h, 0, 255)) / 255.0
    return {'l_im': lr / 255.0, 'h_im': hr, 'l_to_h_img': l2h,
            'l_to_h_img_aug': l2h}
