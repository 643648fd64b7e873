"""PyTorch/CUDA port of srcaco2_tpu for NVIDIA Hopper (H100, sm_90a).

The JAX package `srcaco2_tpu` is the reference; this package imports
nothing of it (nor jax). Entry points run on the card unless the
caller asks for the CPU with device='cpu', where every kernel wrapper
runs its plain PyTorch version.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """None -> 'cuda'. Raises when CUDA is asked for (explicitly or by
    default) and no card is visible: nothing falls back to the CPU
    unless the caller names it."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is visible; pass device="cpu" to run the '
            'plain PyTorch versions on the CPU')
    return dev
