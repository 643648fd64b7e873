"""Image conversion helpers under the reference's familiar names (port
of srcaco2_tpu/utils/image_utils.py).

An API shim over the port's own implementations, so users of the
reference (dlib/utils/utils_image.py) find the utilities they know:
imread_uint:237, uint2single:322, single2tensor3:381, tensor2uint:367,
tensor2uint82float:369, modcrop:583, augment_img:469, imresize_np:1505,
mb_gpu_rgb2ycbcr:618, and the metric entry points :843-:1120. The
helpers work on numpy arrays on the host; the metric entry points take
torch tensors on any device.
"""
import numpy as np
import torch

from srcaco2_tpu_torch.data.io import imread_uint, imsave  # noqa: F401
from srcaco2_tpu_torch.ops.metrics import (  # noqa: F401
    mb_mse as mbatch_gpu_calculate_mse,
    mb_nrmse as mbatch_gpu_calculate_nrmse,
    mb_psnr as mbatch_gpu_calculate_psnr,
    mb_ssim as mbatch_gpu_calculate_ssim,
    rgb2ycbcr as mb_gpu_rgb2ycbcr,
    uint8_round,
)
from srcaco2_tpu_torch.ops.resize import imresize_matlab


def uint2single(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1]."""
    return img.astype(np.float32) / 255.0


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8(np.clip(img * 255.0, 0, 255).round())


def single2tensor3(img: np.ndarray) -> np.ndarray:
    """HWC float -> CHW float (the reference's tensor layout)."""
    return np.ascontiguousarray(img).transpose(2, 0, 1).astype(
        np.float32)


def tensor2single(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img).squeeze()
    if img.ndim == 3:
        img = img.transpose(1, 2, 0)
    return img


def tensor2uint(img) -> np.ndarray:
    x = np.clip(np.asarray(img).squeeze(), 0, 1)
    if x.ndim == 3:
        x = x.transpose(1, 2, 0)
    return np.uint8((x * 255.0).round())


def tensor2uint82float(img) -> torch.Tensor:
    """clamp(0,1)*255 round: the metric-input quantization (a tensor
    stays on its device; an array becomes a CPU tensor)."""
    return uint8_round(torch.as_tensor(img))


def modcrop(img: np.ndarray, sf: int) -> np.ndarray:
    """Crop H,W to multiples of the scale factor."""
    h, w = img.shape[:2]
    return img[:h - h % sf, :w - w % sf, ...]


def shave(img: np.ndarray, border: int) -> np.ndarray:
    return img[border:-border, border:-border, ...] if border else img


def augment_img(img: np.ndarray, mode: int) -> np.ndarray:
    """8-way dihedral augmentation of an HWC numpy image (host version
    of the pipeline's dihedral; mode in [0,7])."""
    k = mode % 4
    out = np.rot90(img, k, axes=(0, 1))
    if mode >= 4:
        out = np.flipud(out)
    return np.ascontiguousarray(out)


def imresize_np(img: np.ndarray, scale: float,
                antialiasing: bool = True) -> np.ndarray:
    """MATLAB-style bicubic on an HWC (or HW) numpy image, on the CPU."""
    x = np.asarray(img, np.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    y = imresize_matlab(torch.from_numpy(np.ascontiguousarray(
        x.transpose(2, 0, 1))), scale, antialias=antialiasing
    ).numpy().transpose(1, 2, 0)
    return y[..., 0] if squeeze else y


def is_caco2(path: str) -> bool:
    return 'caco2' in str(path).lower()


def is_biosr(path: str) -> bool:
    return 'biosr' in str(path).lower()
