"""Periodic weight regularizers (port of
srcaco2_tpu/train/regularizers.py; reference analogs
utils_regularizers.regularizer_orth2 and regularizer_clip, applied every
G_regularizer_{orth,clip}step iterations, model_plain.py:365-387).

Both act in place on the model's parameters (the nn.Parameters, never
the buffers: MemNet's BatchNorm statistics, ENLCN's projections).
"""
import torch

from srcaco2_tpu_torch.bridge import (kernel_from_flax, kernel_to_flax,
                                      orth_kernels)


def _orth_kernel(w: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Soft-orthogonalize one kernel in its flax layout (..., O): SVD of
    the (-1, O) matrix, singular values above 1.5x their mean shrunk by
    eps."""
    u, s, vt = torch.linalg.svd(w.reshape(-1, w.shape[-1]),
                                full_matrices=False)
    s = torch.where(s > 1.5 * s.mean(), s - eps, s)
    return (u @ (s[:, None] * vt)).reshape(w.shape)


@torch.no_grad()
def regularizer_orth(model: torch.nn.Module) -> None:
    """Soft SVD orthogonalization of every parameter JAX holds as a 4-D
    flax conv `kernel` (bridge.orth_kernels), over flax's (H*W*I, O)
    matrix (rows stacked along the leaf's leading axes)."""
    params = dict(model.named_parameters())
    for names, kind in orth_kernels(model):
        leaves = [kernel_to_flax(params[n], kind) for n in names]
        leaf = leaves[0] if len(leaves) == 1 else torch.stack(leaves)
        new = _orth_kernel(leaf)
        for i, n in enumerate(names):
            part = new if len(names) == 1 else new[i]
            params[n].copy_(kernel_from_flax(part, kind))


@torch.no_grad()
def regularizer_clip(params: dict, c_min: float = -1.5, c_max: float = 1.5,
                     eps: float = 1e-4) -> None:
    """Nudge each floating parameter's entries outside [c_min, c_max]
    eps towards the range, in place."""
    for p in params.values():
        if p.is_floating_point():
            p.copy_(torch.where(p > c_max, p - eps, p))
            p.copy_(torch.where(p < c_min, p + eps, p))
