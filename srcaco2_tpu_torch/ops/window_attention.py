"""Windowed multi-head self-attention forward (port of
srcaco2_tpu/ops/pallas/window_attention.py), K6.

`window_attention_ref` is the plain PyTorch version with the numerics of
the TPU kernel `_wmsa_kernel`: q, k and v upcast to f32, q scaled by
hd^-0.5 in f32, both products, the bias and mask adds and the softmax in
f32, the output rounded once to qkv's dtype. `window_attention` is the
wrapper: on a CPU tensor it runs the plain version; on a CUDA tensor it
launches csrc/window_attention.cu or raises. It is forward-only, as the
TPU kernel is (the eval / serving path): on the card it raises when
autograd would need its gradient.

Layouts follow the JAX function: qkv (W, N, 3C) with the heads' q, k
and v side by side in each third; bias (heads, N, N) additive, in any
float dtype (the unfused SwinIR hands it over rounded to the compute
dtype, as JAX does); mask (nW, N, N) additive or None, window w taking
mask[w % nW] (windows are image-major, so this is JAX's tiling of the
mask over the batch, and nW = W is the untiled case). Returns (W, N, C)
in qkv's dtype.

The CUDA source has two bodies, and `_k6_body` alone picks one, by dtype
and shape: 'mma' (bf16 qkv, even hd, a window block within its
shared-memory budget: one CTA per window, tensor-core products with the
probabilities split into bf16 hi + lo) and 'fma' (f32, and the bf16
shapes the mma body does not take: one CTA per window and head, f32 FMA
products). Both compute the function above; the mma body reads a bf16
bias as it is handed.
"""
import ctypes
import functools

import torch

from srcaco2_tpu_torch.ops.swin_block import _bind, _launch

MAX_N = 64      # tokens per window the CUDA kernel takes (ws <= 8)
MAX_HD = 64     # head width the CUDA kernel takes
MMA_SMEM_MAX = 232448   # shared memory a CTA may opt in to on sm_90


def _mma_smem_bytes(c: int) -> int:
    """Shared memory of the mma body per CTA (csrc mma_layout): the
    window's qkv block and the output tile, MAX_N rows each in bf16, and
    the window's mask, MAX_N rows of MAX_N + 8 f32."""
    align16 = lambda v: (v + 15) // 16 * 16
    return (align16(2 * MAX_N * 3 * c) + align16(2 * MAX_N * c)
            + 4 * MAX_N * (MAX_N + 8))


def _k6_body(dtype, n: int, c: int, heads: int) -> str:
    """The CUDA body that computes K6 for qkv of this dtype and shape:
    'mma' where the mma body takes it, else 'fma'. A copy of the
    library's rule (csrc mma_takes, exported as
    window_attention_mma_smem), so that the choice needs no build on the
    CPU; chip_smoke.py's kernel_check_wmsa holds the two against each
    other on the card."""
    hd = c // heads
    if (dtype == torch.bfloat16 and 0 < n <= MAX_N and c % heads == 0
            and 0 < hd <= MAX_HD and hd % 2 == 0
            and _mma_smem_bytes(c) <= MMA_SMEM_MAX):
        return 'mma'
    return 'fma'


def _window_mask(mask: torch.Tensor, w: int) -> torch.Tensor:
    """(W, N, N) f32: window w's mask[w % nW]."""
    return mask.float()[torch.arange(w, device=mask.device) % mask.shape[0]]


def window_attention_ref(qkv: torch.Tensor, bias: torch.Tensor,
                         mask, heads: int) -> torch.Tensor:
    """Plain version of K6 (see the module docstring)."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    t = qkv.float().reshape(w, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]                         # (W, heads, N, hd)
    attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
    attn = attn + bias.float()[None]
    if mask is not None:
        attn = attn + _window_mask(mask, w)[:, None]
    attn = torch.softmax(attn, dim=-1)
    out = attn @ v
    return out.permute(0, 2, 1, 3).reshape(w, n, c).to(qkv.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(body: str):
    """The C entry of one body and the library's error-name function."""
    if body == 'fma':
        # (compute_bf16, qkv, bias, mask, out, W, N, C, heads, nW, scale,
        #  stream)
        args = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    else:
        # (qkv, bias, bias_bf16, mask, out, W, N, C, heads, nW, scale,
        #  stream)
        args = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5)
    entry = {'fma': 'window_attention_fwd',
             'mma': 'window_attention_mma_fwd'}[body]
    return _bind('window_attention', entry,
                 args + [ctypes.c_float, ctypes.c_void_p])


def _k6_operands(bias, mask, body: str):
    """(bias, mask) as the body reads them: the mma body takes a bf16 or
    f32 bias as it is (made contiguous if it is not), the fma body an f32
    one; the mask is f32."""
    if body == 'mma' and bias.dtype in (torch.bfloat16, torch.float32):
        bias = bias.contiguous()
    else:
        bias = bias.float().contiguous()
    return bias, None if mask is None else mask.float().contiguous()


def _check(qkv, bias, mask, heads):
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'qkv is {qkv.dtype}: the kernel takes f32 or bf16')
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError('qkv must be a contiguous (W, N, 3C) tensor')
    w, n, c3 = qkv.shape
    if c3 % 3 or (c3 // 3) % heads:
        raise ValueError(f'3C={c3} must split into 3 x {heads} heads')
    hd = c3 // 3 // heads
    if not (0 < n <= MAX_N and 0 < hd <= MAX_HD and w > 0):
        raise ValueError(f'N={n}, hd={hd}, W={w}: the kernel takes '
                         f'N <= {MAX_N} and hd <= {MAX_HD}')
    if tuple(bias.shape) != (heads, n, n) or bias.device != qkv.device:
        raise ValueError(f'bias must be ({heads}, {n}, {n}) on {qkv.device}')
    if mask is not None and (mask.dim() != 3 or mask.shape[0] < 1
                             or tuple(mask.shape[1:]) != (n, n)
                             or mask.device != qkv.device):
        raise ValueError(f'mask must be (nW, {n}, {n}) on {qkv.device}')


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask=None, *,
                     heads: int) -> torch.Tensor:
    """softmax(q.k^T hd^-0.5 + bias + mask).v per window and head: the
    plain version on a CPU tensor, K6 on a CUDA tensor (or a raise)."""
    if qkv.device.type == 'cpu':
        return window_attention_ref(qkv, bias, mask, heads)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qkv, bias, mask)):
        raise RuntimeError(
            'window_attention has no backward (the TPU kernel is '
            'forward-only): run it under torch.no_grad() or '
            'torch.inference_mode(), or build the model with '
            'use_pallas_attn=False to train')
    if qkv.device.type != 'cuda':
        raise ValueError(f'unsupported device {qkv.device}')
    _check(qkv, bias, mask, heads)
    w, n, c3 = qkv.shape
    return _run(_k6_body(qkv.dtype, n, c3 // 3, heads), qkv, bias, mask,
                heads)


def _run(body: str, qkv, bias, mask, heads: int) -> torch.Tensor:
    """One launch of `body` on checked CUDA inputs; counts it."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    bias, mask = _k6_operands(bias, mask, body)
    out = torch.empty((w, n, c), dtype=qkv.dtype, device=qkv.device)
    fn, err_name = _kernel(body)
    mask_ptr = None if mask is None else mask.data_ptr()
    n_mask = 0 if mask is None else mask.shape[0]
    if body == 'fma':
        args = (int(qkv.dtype == torch.bfloat16), qkv.data_ptr(),
                bias.data_ptr(), mask_ptr)
    else:
        args = (qkv.data_ptr(), bias.data_ptr(),
                int(bias.dtype == torch.bfloat16), mask_ptr)
    _launch(fn, err_name, f'window_attention ({body} body)',
            args + (out.data_ptr(), w, n, c, heads, n_mask,
                    (c // heads) ** -0.5), qkv.device)
    window_attention.launches += 1
    window_attention.body_launches[body] += 1
    return out


window_attention.launches = 0
# launches by body ('mma', 'fma'); window_attention.launches is their sum
window_attention.body_launches = {'mma': 0, 'fma': 0}
