"""Patch-origin sampling: uniform / ROI / EDT / EDT*ROI (port of
srcaco2_tpu/data/sampling.py).

As the reference's PatchSampler: the draw runs on the bicubically
pre-upscaled LR image (uint8); a patch *center* is drawn over the
valid-center grid [psize//2, H - ceil(psize/2)) with per-pixel weights,
origin = center - psize//2; ROI weights exp(5 roi) + 1, EDT weights
edt + 1, EDT*ROI the product of both normalized maps; ROI = (img >= th)
with th fixed or Otsu's (nbins = number of colors).

The host functions (numpy / scipy) are the reference path; the device
functions run on a stack of images at once: Otsu over a 256-bin
histogram, the octagonal-chamfer EDT capped at 48 (48 erosions
alternating the 4- and 8-neighborhood), the weight maps and the
categorical draw.
"""
import numpy as np
import torch
import torch.nn.functional as F

from srcaco2_tpu_torch import constants

EDT_CAP = 48


# --------------------------------------------------------------- host side
def otsu_threshold(img: np.ndarray, nbins: int = 256) -> float:
    """Otsu's method over the image value range (skimage-compatible):
    returns the bin center maximizing inter-class variance."""
    img = np.asarray(img).ravel()
    vmin, vmax = img.min(), img.max()
    if vmin == vmax:
        return float(vmin)
    hist, edges = np.histogram(img, bins=nbins,
                               range=(float(vmin), float(vmax)))
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = hist.astype(np.float64)
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    m1 = np.cumsum(hist * centers) / np.maximum(w1, 1e-12)
    m2 = (np.cumsum((hist * centers)[::-1]) / np.maximum(w2[::-1], 1e-12)
          )[::-1]
    var_between = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[np.argmax(var_between)])


def roi_mask(img: np.ndarray, threshold_style: str, threshold,
             nbins: int = 256) -> np.ndarray:
    if threshold_style == constants.TH_AUTO:
        th = otsu_threshold(img, nbins)
    elif threshold_style == constants.TH_FIX:
        th = float(threshold)
    else:
        raise NotImplementedError(threshold_style)
    return (img >= th).astype(np.float64)


def edt_map(roi: np.ndarray) -> np.ndarray:
    """Euclidean distance transform of the ROI (host; scipy)."""
    from scipy.ndimage import distance_transform_edt
    return distance_transform_edt(roi)


def _center_crop_window(m: np.ndarray, psize: int) -> np.ndarray:
    h, w = m.shape[-2:]
    lhalf, rhalf = psize // 2, -(-psize // 2)
    return m[..., lhalf:h - rhalf, lhalf:w - rhalf]


def origin_prob_map(img: np.ndarray, sample_type: str, psize: int,
                    threshold_style: str = constants.TH_AUTO,
                    threshold=None, nbins: int = 256) -> np.ndarray:
    """Probability map over valid patch centers (host reference path)."""
    if sample_type == constants.SAMPLE_UNIF:
        win = _center_crop_window(np.zeros_like(img, dtype=np.float64),
                                  psize)
        return np.full(win.shape, 1.0 / win.size)
    roi = roi_mask(img, threshold_style, threshold, nbins)
    if sample_type == constants.SAMPLE_ROI:
        t = np.exp(_center_crop_window(roi, psize) * 5.0) + 1.0
        return t / t.sum()
    if sample_type == constants.SAMPLE_EDT:
        t = _center_crop_window(edt_map(roi), psize) + 1.0
        return t / t.sum()
    if sample_type == constants.SAMPLE_EDTXROI:
        tr = np.exp(_center_crop_window(roi, psize) * 5.0) + 1.0
        te = _center_crop_window(edt_map(roi), psize) + 1.0
        p = (tr / tr.sum()) * (te / te.sum())
        return p / p.sum()
    raise NotImplementedError(sample_type)


def sample_origin_host(rng: np.random.Generator, img: np.ndarray,
                       sample_type: str, psize: int,
                       threshold_style: str = constants.TH_AUTO,
                       threshold=None):
    """Draw one (x0, y0) patch origin on the host."""
    h, w = img.shape
    if sample_type == constants.SAMPLE_UNIF:
        return (int(rng.integers(0, max(0, h - psize) + 1)),
                int(rng.integers(0, max(0, w - psize) + 1)))
    p = origin_prob_map(img, sample_type, psize, threshold_style, threshold)
    flat = rng.choice(p.size, p=p.ravel())
    ch, cw = np.unravel_index(flat, p.shape)
    # center = cropped index + psize//2; origin = center - psize//2 = index
    return int(ch), int(cw)


# -------------------------------------------------------------- device side
def otsu_threshold_device(img_u8: torch.Tensor,
                          nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold of each image of a (..., H, W) uint8 stack, f32
    (...,), on the stack's device. The bins span each image's [min, max]
    as the host version's; a pixel's bin is ((x - vmin) / span * nbins)
    truncated, in f32 and in that order (JAX's). The histogram counts
    are integers and the class statistics are taken in float64, so that
    the card and the CPU pick the same bin."""
    lead = img_u8.shape[:-2]
    x = img_u8.reshape(-1, img_u8.shape[-2] * img_u8.shape[-1]).float()
    b = x.shape[0]
    vmin = x.amin(1, keepdim=True)
    vmax = x.amax(1, keepdim=True)
    span = torch.clamp(vmax - vmin, min=1e-6)
    idxs = torch.clip(((x - vmin) / span * nbins).to(torch.int32), 0,
                      nbins - 1).long()
    offs = torch.arange(b, device=x.device)[:, None] * nbins
    hist = torch.bincount((idxs + offs).reshape(-1),
                          minlength=b * nbins).reshape(b, nbins).double()
    centers = vmin + (torch.arange(nbins, dtype=torch.float32,
                                   device=x.device) + 0.5) * (span / nbins)
    c64 = centers.double()
    w1 = hist.cumsum(1)
    w2 = hist.flip(1).cumsum(1).flip(1)
    m1 = (hist * c64).cumsum(1) / torch.clamp(w1, min=1e-12)
    m2 = ((hist * c64).flip(1).cumsum(1)
          / torch.clamp(w2.flip(1), min=1e-12)).flip(1)
    var_between = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    th = centers.gather(1, var_between.argmax(1, keepdim=True))
    return torch.where(vmax == vmin, vmin, th).reshape(lead)


def edt_device(roi: torch.Tensor, max_dist: int = EDT_CAP) -> torch.Tensor:
    """Octagonal-chamfer approximation of the Euclidean distance
    transform of each (..., H, W) f32 {0, 1} map: the number of erosions
    a pixel survives, alternating the 4-neighborhood (cross, even
    steps) and the full 3x3 neighborhood (odd steps) of a zero-padded
    map, capped at max_dist. Exact in f32 (small integers)."""
    lead = roi.shape[:-2]
    r = roi.reshape(-1, 1, *roi.shape[-2:])
    dist = r
    h, w = r.shape[-2:]
    for i in range(max_dist):
        rp = F.pad(r, (1, 1, 1, 1))

        def sl(dy, dx):
            return rp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

        eroded = r
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            eroded = torch.minimum(eroded, sl(dy, dx))
        if i % 2:
            for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
                eroded = torch.minimum(eroded, sl(dy, dx))
        dist = dist + eroded
        r = eroded
    return dist.reshape(*lead, h, w)


def origin_weights(l2h_u8: torch.Tensor, sample_type: str, psize: int,
                   threshold_style: str = constants.TH_AUTO,
                   threshold: float = 0.0) -> torch.Tensor:
    """The categorical weights of the patch origins of each image of a
    (B, H, W) uint8 stack of pre-upscaled LR images: (B, H - psize,
    W - psize) f32 over the valid centers, entry (i, j) the weight of
    origin (i, j) (JAX's data/pipeline.py:_sample_origin)."""
    if threshold_style == constants.TH_AUTO:
        th = otsu_threshold_device(l2h_u8)[:, None, None]
    elif threshold_style == constants.TH_FIX:
        th = torch.full((1, 1, 1), float(threshold), device=l2h_u8.device)
    else:
        raise NotImplementedError(threshold_style)
    roi = (l2h_u8.float() >= th).float()
    if sample_type == constants.SAMPLE_ROI:
        return torch.exp(_center_crop_window(roi, psize) * 5.0) + 1.0
    if sample_type == constants.SAMPLE_EDT:
        return _center_crop_window(edt_device(roi), psize) + 1.0
    if sample_type == constants.SAMPLE_EDTXROI:
        wr = torch.exp(_center_crop_window(roi, psize) * 5.0) + 1.0
        we = _center_crop_window(edt_device(roi), psize) + 1.0
        return (wr / wr.sum((1, 2), keepdim=True)) \
            * (we / we.sum((1, 2), keepdim=True))
    raise NotImplementedError(sample_type)


def sample_origin_device(gen: torch.Generator, weights: torch.Tensor,
                         k: int = 1):
    """k origins per (Hc, Wc) weight map of a (B, Hc, Wc) stack, drawn
    from `gen` independently (with replacement), each with probability
    proportional to its weight (the distribution of
    jax.random.categorical over log(weights)): (x0, y0), (B,) int64 each
    for k = 1, else (B, k)."""
    wc = weights.shape[-1]
    flat = torch.multinomial(weights.reshape(weights.shape[0], -1), k,
                             replacement=True, generator=gen)
    if k == 1:
        flat = flat.reshape(-1)
    return flat // wc, flat % wc
