"""Bicubic-interpolation pseudo-model (port of
srcaco2_tpu/models/interpolate.py): the baseline evaluated at step 0 and
beside every test eval, F.interpolate(..., antialias=True) of the
reference, computed by ops/resize.resize2d."""
import torch

from srcaco2_tpu_torch.ops import resize as R


def interpolate_model(l_im: torch.Tensor, scale: int,
                      mode: str = 'bicubic') -> dict:
    """l_im: NCHW [0,1] -> upscaled NCHW [0,1], antialiased."""
    h, w = l_im.shape[-2], l_im.shape[-1]
    method = {'bicubic': R.TORCH_BICUBIC, 'bilinear': R.BILINEAR,
              'nearest': R.NEAREST}[mode]
    out = R.resize2d(l_im, (h * scale, w * scale), method=method,
                     antialias=True)
    return {'out': torch.clip(out, 0.0, 1.0)}
