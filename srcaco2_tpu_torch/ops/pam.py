"""Permutohedral attention (port of srcaco2_tpu/ops/pam.py): attention
with a Gaussian kernel over the feature space in O(n), through the host
lattice (native/): out_i = sum_j exp(-|f_i - f_j|^2 / 2) v_j, normalised
by the same filtering of a column of ones (floored at 1e-8).

The lattice runs on the host, as the JAX package runs it through
pure_callback: the inputs are copied there and the result comes back on
the values' device. Forward only, as in JAX (pure_callback has no
derivative). Not on the SR path.
"""
import numpy as np
import torch

from srcaco2_tpu_torch import native


def permutohedral_attention(features: torch.Tensor, values: torch.Tensor,
                            normalize: bool = True) -> torch.Tensor:
    """features: (B, N, D); values: (B, N, V). Returns (B, N, V) f32 on
    the values' device: the normalised attention, or with normalize
    False the filtered values alone."""
    b, n, v = values.shape
    vals = values.detach().float()
    if normalize:
        vals = torch.cat([vals, torch.ones((b, n, 1), dtype=vals.dtype,
                                           device=vals.device)], -1)
    feats = features.detach().float().cpu().numpy()
    host = vals.cpu().numpy()
    out = torch.from_numpy(np.stack([
        native.permutohedral_filter(f, x) for f, x in zip(feats, host)
    ]).astype(np.float32)).to(values.device)
    if normalize:
        return out[..., :v] / torch.clamp_min(out[..., v:], 1e-8)
    return out
