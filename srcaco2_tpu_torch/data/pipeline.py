"""Device-resident input pipeline: the per-step batch assembly (port of
srcaco2_tpu/data/pipeline.py).

The uint8 image stacks live on the device and every per-step transform
runs there: the patch-origin draw (uniform, or weighted by the ROI / EDT
maps of the pre-upscaled LR image, data/sampling.py), the paired crops
(HR at (x0, y0), LR at (x0 // s, y0 // s), keeping the reference's
up-to-(s-1)-pixel misalignment unless `aligned_crops`), the joint 8-way
dihedral augment, the LR-only local augs (block blur, binary dot noise,
additive Gaussian noise; mask-based, shapes static), the uint8-quantized
bicubic `l_to_h` of the augmented LR crop, and the per-pixel
inverse-color-frequency weights (ppiw).

JAX draws from `fold_in` streams that torch cannot reproduce, so the
batch is built in two parts: `draw` takes every random choice (origins,
dihedral modes, the local augs' coins, blocks, dot masks and noise
fields) from an explicit torch.Generator, and `assemble` is
deterministic given them (tests feed it JAX's own draws).
"""
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import sampling as S
from srcaco2_tpu_torch.data.transforms import dihedral, reflect_pad
from srcaco2_tpu_torch.losses.ops import conv_f32
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


def _u8_quant(x01: torch.Tensor) -> torch.Tensor:
    """Round to the uint8 grid in [0,1] (the reference materializes
    intermediate images as uint8)."""
    return torch.round(torch.clip(x01, 0.0, 1.0) * 255.0) / 255.0


class BlockAug(NamedTuple):
    """One local aug's choices for a batch: `apply` (B,) bool, its coin
    (uniform < prob); `box` (B, 4) int64, the block's top row, left
    column, height and width on the LR patch (side fraction N(area,
    0.01) clipped to [0, 1], corner uniform); and `field`: for the blur
    the (B,) bool coin that blurs inside the block (uniform >= 0.98)
    rather than outside it, for the dot noise the (B, 1, h, w) f32 keep
    mask (Bernoulli of 1 - p), for the Gaussian noise the (B, C, h, w)
    f32 standard normal field (scaled by the std in assemble)."""
    apply: torch.Tensor
    box: torch.Tensor
    field: torch.Tensor


class Draws(NamedTuple):
    """A batch's random choices, (B,) int64 each: the HR patch origin
    (row x0, column y0) and the dihedral mode in [0, 8); `lsh`, the CPU
    generator of the step's hash rotations (NLSN,
    utils/reproducibility.lsh_generator; None: the model's own); and the
    local augs' choices (BlockAug, None where the aug is off)."""
    x0: torch.Tensor
    y0: torch.Tensor
    mode: torch.Tensor
    lsh: Optional[torch.Generator] = None
    blur: Optional[BlockAug] = None
    dot: Optional[BlockAug] = None
    gaus: Optional[BlockAug] = None


def _aug_on(cfg: PipeConfig, name: str) -> bool:
    return bool(getattr(cfg, name)) and getattr(cfg, f'{name}_area') > 0


def _draw_block(gen, n, side, area, prob) -> tuple:
    """(apply, box) of one block aug for n samples (JAX's _block_mask
    and its apply coin)."""
    dev = gen.device
    apply = torch.rand(n, generator=gen, device=dev) < prob
    ratio = torch.clip(torch.randn(n, generator=gen, device=dev) * 0.01
                       + area, 0.0, 1.0)
    size = (side * ratio).long()
    hi = torch.clamp(side - size + 1, min=1)

    def corner():
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        return torch.minimum((u * hi).long(), hi - 1)
    return apply, torch.stack([corner(), corner(), size, size], 1)


def draw(gen: torch.Generator, n: int, cfg: PipeConfig, hr_hw,
         weights: Optional[torch.Tensor] = None) -> Draws:
    """Patch origins, dihedral modes and local-aug choices for n samples
    from `gen`, on the generator's device. Uniform origins range over
    the HR height for both axes, as the JAX pipeline draws them
    (pipeline.py:256-258); ROI / EDT origins are drawn from `weights`,
    the (n, Hc, Wc) origin weight maps of the samples' images
    (OriginWeights.of)."""
    dev = gen.device
    if cfg.sample_tr_patch == constants.SAMPLE_UNIF:
        hi = max(0, int(hr_hw[0]) - cfg.h_size) + 1
        x0 = torch.randint(0, hi, (n,), generator=gen, device=dev)
        y0 = torch.randint(0, hi, (n,), generator=gen, device=dev)
    else:
        if weights is None or weights.shape[0] != n:
            raise ValueError(f'{cfg.sample_tr_patch} sampling needs the '
                             f'origin weights of the {n} samples')
        x0, y0 = S.sample_origin_device(gen, weights)
    mode = torch.randint(0, 8, (n,), generator=gen, device=dev)
    ls, c = cfg.l_size, cfg.n_channels
    augs = {}
    if _aug_on(cfg, 'da_blur'):
        apply, box = _draw_block(gen, n, ls, cfg.da_blur_area,
                                 cfg.da_blur_prob)
        inside = torch.rand(n, generator=gen, device=dev) >= 0.98
        augs['blur'] = BlockAug(apply, box, inside)
    if _aug_on(cfg, 'da_dot_bin_noise'):
        apply, box = _draw_block(gen, n, ls, cfg.da_dot_bin_noise_area,
                                 cfg.da_dot_bin_noise_prob)
        keep = (torch.rand((n, 1, ls, ls), generator=gen, device=dev)
                < 1.0 - cfg.da_dot_bin_noise_p).float()
        augs['dot'] = BlockAug(apply, box, keep)
    if _aug_on(cfg, 'da_add_gaus_noise'):
        apply, box = _draw_block(gen, n, ls, cfg.da_add_gaus_noise_area,
                                 cfg.da_add_gaus_noise_prob)
        z = torch.randn((n, c, ls, ls), generator=gen, device=dev)
        augs['gaus'] = BlockAug(apply, box, z)
    return Draws(x0, y0, mode, **augs)


def l2h_u8(lr_u8: torch.Tensor, hr_hw) -> torch.Tensor:
    """The uint8 bicubic pre-upscale to hr_hw of the first channel of
    each image of an (N, h, w, C) uint8 stack: (N, H, W) uint8, the
    image the origin draw weighs (JAX: round(clip(resize2d(lr), 0,
    255))[0] per sample)."""
    up = resize2d(lr_u8[..., :1].permute(0, 3, 1, 2).float(),
                  tuple(int(v) for v in hr_hw))[:, 0]
    return torch.round(torch.clip(up, 0, 255)).to(torch.uint8)


def cache_budget(device) -> int:
    """Bytes the origin weight maps of a whole train stack may take to be
    kept: an eighth of the card's memory, 2 GiB on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_properties(device).total_memory // 8
    return 2 << 30


class OriginWeights:
    """The ROI / EDT origin weight maps (sampling.origin_weights) of the
    images of a staged train stack. They depend on the staged LR image
    only: with `cache` they are computed once, `chunk` images at a time,
    and kept (N x Hc x Wc f32); else the batch's maps are computed at
    each step, as JAX does."""

    def __init__(self, lr_u8: torch.Tensor, hr_hw, cfg: PipeConfig,
                 cache: bool, chunk: int = 64):
        self.lr_u8, self.hr_hw, self.cfg = lr_u8, tuple(hr_hw), cfg
        self.maps = None
        if cache:
            self.maps = torch.cat([self._compute(lr_u8[i:i + chunk])
                                   for i in range(0, len(lr_u8), chunk)])

    @staticmethod
    def nbytes(n: int, hr_hw, cfg: PipeConfig) -> int:
        return 4 * n * (int(hr_hw[0]) - cfg.h_size) \
            * (int(hr_hw[1]) - cfg.h_size)

    def _compute(self, lr_u8):
        cfg = self.cfg
        return S.origin_weights(l2h_u8(lr_u8, self.hr_hw),
                                cfg.sample_tr_patch, cfg.h_size,
                                cfg.th_style, cfg.th_fix)

    def of(self, idxs: torch.Tensor) -> torch.Tensor:
        """(B, Hc, Wc) weight maps of the images idxs (B,)."""
        idxs = idxs.long()
        if self.maps is not None:
            return self.maps[idxs]
        return self._compute(self.lr_u8[idxs])


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


def _block_mask(box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 1, h, w) f32: 1 inside each sample's block (top, left, height,
    width)."""
    ii = torch.arange(h, device=box.device)[None, :, None]
    jj = torch.arange(w, device=box.device)[None, None, :]
    t, l_, bh, bw = (box[:, k, None, None] for k in range(4))
    m = (ii >= t) & (ii < t + bh) & (jj >= l_) & (jj < l_ + bw)
    return m[:, None].float()


@functools.lru_cache(maxsize=8)
def _gauss_kernel(sigma: float) -> np.ndarray:
    radius = int(4.0 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a (B, C, H, W) f32 batch (scipy.ndimage
    gaussian_filter analog: truncate = 4 sigma, reflect boundary, also
    for a radius past the side)."""
    k = _gauss_kernel(float(sigma))
    r = len(k) // 2
    b, c, h, w = img.shape
    x = reflect_pad(img.reshape(b * c, 1, h, w), r)
    x = conv_f32(x, k.reshape(1, 1, -1, 1))
    x = conv_f32(x, k.reshape(1, 1, 1, -1))
    return x.reshape(b, c, h, w)


def _apply_local_augs(lr: torch.Tensor, draws: Draws,
                      cfg: PipeConfig) -> torch.Tensor:
    """The LR-only block augs of a (B, C, h, w) f32 batch in [0, 1], in
    JAX's order (blur, dot noise, Gaussian noise), from the draws."""
    h, w = lr.shape[-2:]

    def get(name, key):
        aug = getattr(draws, key)
        if aug is None:
            raise ValueError(f'{name} is on but the draws hold none')
        col = aug.apply[:, None, None, None]
        return aug, col, _block_mask(aug.box, h, w)

    if _aug_on(cfg, 'da_blur'):
        aug, apply, m = get('da_blur', 'blur')
        blurred = _gauss_blur(lr, cfg.da_blur_sigma)
        # inside (prob .02): blur the block; else blur all but the block
        blended = torch.where(aug.field[:, None, None, None],
                              m * blurred + (1 - m) * lr,
                              (1 - m) * blurred + m * lr)
        lr = torch.where(apply, blended, lr)
    if _aug_on(cfg, 'da_dot_bin_noise'):
        aug, apply, m = get('da_dot_bin_noise', 'dot')
        lr = torch.where(apply, lr * (m * aug.field + (1 - m)), lr)
    if _aug_on(cfg, 'da_add_gaus_noise'):
        aug, apply, m = get('da_add_gaus_noise', 'gaus')
        lr = torch.where(apply,
                         lr + m * (cfg.da_add_gaus_noise_std * aug.field), lr)
    return lr


def assemble(hr_u8: torch.Tensor, lr_u8: torch.Tensor, idxs: torch.Tensor,
             draws: Draws, cfg: PipeConfig,
             ppiw_table: Optional[torch.Tensor] = None) -> dict:
    """One train batch from its draws, on the stacks' device.

    hr_u8: (N, H, W, C) uint8; lr_u8: (N, h, w, C) uint8; idxs: (B,) int.
    Returns NCHW f32 in [0, 1]: l_im (B,C,ls,ls), h_im (B,C,hs,hs),
    l_to_h_img and l_to_h_img_aug (B,C,hs,hs), and with cfg.ppiw and a
    table the per-pixel weights h_per_pixel_weight (B,C,hs,hs), the
    table's entry of each HR pixel's level."""
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
    l_im = torch.clip(_apply_local_augs(l_im, draws, cfg), 0.0, 1.0)
    l2h = _u8_quant(resize2d(l_im, (hs, hs)))
    out = {'l_im': l_im, 'h_im': h_im, 'l_to_h_img': l2h,
           'l_to_h_img_aug': l2h}
    if cfg.ppiw and ppiw_table is not None:
        cols = torch.round(torch.clip(h_im, 0, 1) * 255.0).long()
        out['h_per_pixel_weight'] = ppiw_table[cols]
    return out


def make_train_batch(hr_u8: torch.Tensor, lr_u8: torch.Tensor,
                     idxs: torch.Tensor, gen: torch.Generator,
                     cfg: PipeConfig,
                     ppiw_table: Optional[torch.Tensor] = None) -> dict:
    """assemble(draw(...)): a train batch with fresh draws from gen (the
    ROI / EDT weights computed for the batch's images)."""
    weights = None
    if cfg.sample_tr_patch != constants.SAMPLE_UNIF:
        weights = OriginWeights(lr_u8, hr_u8.shape[1:3], cfg,
                                cache=False).of(idxs)
    return assemble(hr_u8, lr_u8, idxs,
                    draw(gen, idxs.shape[0], cfg, hr_u8.shape[1:3],
                         weights), cfg, ppiw_table)


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


def per_color_weights(hr_u8: np.ndarray, min_w: float) -> np.ndarray:
    """Inverse-frequency per-color weight table (256,) f32 from the train
    HR stack, renormalized to [min_w, 1]; 0 for an absent color
    (reference: dataset_dpsr.py:592-643)."""
    hist = np.bincount(np.asarray(hr_u8).ravel(),
                       minlength=256).astype(np.float64)
    hist = hist / hist.sum()
    w = 1.0 / np.maximum(hist, 1e-12)
    w[hist == 0] = 0.0
    nz = w > 0
    wmin, wmax = w[nz].min(), w[nz].max()
    if wmax > wmin:
        w[nz] = (w[nz] - wmin) / (wmax - wmin) * (1.0 - min_w) + min_w
    else:
        w[nz] = 1.0
    return w.astype(np.float32)
