"""The yardstick's fixed arithmetic: the chips' peaks, the operations and
bytes of each hand-written kernel's launch, and each architecture's
forward operations per sample (`counts/<arch>.py`, found by the
configuration's `arch`), all counted from the shapes.

Operations are the multiply-adds of the matrix products and convolutions
(two operations each); element-wise work (LayerNorm, softmax, GELU,
PReLU, adds) is not counted. Recomputation (checkpointing, a kernel that
recomputes its forward in the backward) is counted where a kernel does
it and never in a step's useful work.
"""
GIB = 2 ** 30

# NVIDIA's data sheet for the H100 SXM: dense bf16 tensor-core peak and
# HBM3 rate, at the full 700 W power limit
PEAKS = {'NVIDIA H100 80GB HBM3': dict(flops=989e12, bytes_per_s=3.35e12)}


def peak(kind: str):
    return PEAKS.get(kind)


def swin_block_fwd_flops_per_token(c: int, ch: int, ws: int) -> int:
    """One token through a Swin block's forward: the qkv (3 C^2), output
    (C^2) and MLP (2 C CH) products, and attention inside its ws^2-token
    window (q.k^T and p.v, ws^2 C each). At C 180, CH 360, ws 8: 564,480."""
    return 2 * (3 * c * c + c * c + 2 * c * ch) + 2 * 2 * ws * ws * c


def swin_block_bwd_flops_per_token(c: int, ch: int, ws: int) -> int:
    """One token through K2, the block backward from the block's input:
    the forward without its last product recomputed (3 C^2 + C^2 + C CH,
    and attention), the input gradient's chain and the weight gradients
    (4 C CH + 8 C^2), and attention's backward (four ws^2 C products).
    At C 180, CH 360, ws 8: 1,563,840."""
    return (2 * (3 * c * c + c * c + c * ch) + 2 * 2 * ws * ws * c
            + 2 * (4 * c * ch + 8 * c * c) + 2 * 4 * ws * ws * c)


def _block_params(c: int, ch: int, ws: int, heads: int) -> int:
    """A block's parameters: two LayerNorms (2 C each), qkv (3 C^2 + 3 C),
    output (C^2 + C), MLP (2 C CH + CH + C) and the position-bias table
    ((2 ws - 1)^2 heads)."""
    return (4 * c + 3 * c * c + 3 * c + c * c + c + 2 * c * ch + ch + c
            + (2 * ws - 1) ** 2 * heads)


def swin_kernel_work(kernel: str, cfg: dict, tokens: int, t: int) -> tuple:
    """(operations, bytes) of one launch of K1 (`k1`, the block forward),
    K2 (`k2`, its backward) or K5 (`k5`, the grouped forward of serving)
    over `tokens` tokens, the attention bias covering t x t tokens per
    head. Bytes count each input read once and each output written once:
    the bf16 activations (2 bytes per token and channel), the f32 bias
    table expanded to (heads, t, t), and the weights in bf16; K2 also
    reads the upstream gradient and writes the input gradient (bf16) and
    the f32 weight gradients. At the flagship's training shape (128
    patches of 256 tokens) K1's operations are 18.50 GFLOP, K2's 51.24;
    K5's at 8 images of 64 x 64 are 18.50."""
    c, ws = cfg['embed_dim'], cfg['window_size']
    heads = cfg['num_heads'][0]
    ch = int(c * cfg['mlp_ratio'])
    act = tokens * c * 2
    bias = heads * t * t * 4
    params = _block_params(c, ch, ws, heads)
    if kernel in ('k1', 'k5'):
        return (tokens * swin_block_fwd_flops_per_token(c, ch, ws),
                2 * act + bias + 2 * params)
    if kernel == 'k2':
        return (tokens * swin_block_bwd_flops_per_token(c, ch, ws),
                3 * act + bias + 2 * params + 4 * params)
    raise KeyError(kernel)


def conv_flops(cin: int, cout: int, k: int, out_pixels: int) -> int:
    return 2 * cin * cout * k * k * out_pixels



def forward_flops(cfg: dict, h: int, w: int) -> int:
    """The operations of one h x w LR sample through the configuration's
    network forward."""
    import importlib
    mod = importlib.import_module(f'benchmark.counts.{cfg["arch"]}')
    return mod.forward_flops(cfg, h, w)
