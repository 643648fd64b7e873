"""The dense-CRF (bilateral relaxation) loss on the host lattice (port of
srcaco2_tpu/losses/crf.py): loss = -(1/N) sum(s * W s), W the bilateral
affinity, Gaussian in (xy / sigma_xy, intensity / sigma_rgb), computed by
the permutohedral lattice (native/). W is symmetric, so the gradient with
respect to s is -(2/N) W s, taken from the forward's filtered tensor: the
backward costs nothing more. No gradient flows to the images.

The lattice runs on the host, as the JAX package runs it through
pure_callback: the forward copies the images and the segmentations to
the host, filters them there and returns the loss on the input's device.
Not on the SR path.
"""
import torch

from srcaco2_tpu_torch import native


class _DenseCRFLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, images, segmentations, sigma_rgb, sigma_xy):
        seg = segmentations.float()
        filtered = torch.from_numpy(native.bilateral_filter(
            images.detach().float().cpu().numpy(),
            seg.detach().cpu().numpy(), float(sigma_rgb),
            float(sigma_xy))).to(segmentations.device)
        n = segmentations.shape[0]
        ctx.save_for_backward(filtered)
        ctx.n = n
        ctx.seg_dtype = segmentations.dtype
        return -(seg * filtered).sum() / n

    @staticmethod
    def backward(ctx, g):
        filtered, = ctx.saved_tensors
        return (None, (-2.0 * g * filtered / ctx.n).to(ctx.seg_dtype),
                None, None)


def dense_crf_loss(images: torch.Tensor, segmentations: torch.Tensor,
                   sigma_rgb: float = 15.0,
                   sigma_xy: float = 80.0) -> torch.Tensor:
    """images: (N, C, H, W) in [0, 255], C in {1, 3}; segmentations:
    (N, K, H, W), softmaxed. A scalar f32 loss on the segmentations'
    device."""
    return _DenseCRFLoss.apply(images, segmentations, sigma_rgb, sigma_xy)
