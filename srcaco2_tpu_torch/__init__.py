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


def exact_f32(device: torch.device) -> None:
    """On the card, f32 computes in true f32 as the JAX package does
    (TF32 off for matmuls and cuDNN; bf16 operands are exact in TF32
    either way) and cuDNN picks deterministic algorithms (its default for
    an f32 transposed convolution sums with atomics, so that two f32
    forwards of MSLapSRN or SRFBN would differ in the last bits and a
    re-evaluation would not reproduce a test). No-op on the CPU."""
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
