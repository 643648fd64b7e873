"""The kernel wrappers' launch counts. Each wrapper of K1-K6 adds one to
its `launches` attribute where it launches its kernel on the card, and
nowhere else (never for its plain version on the CPU)."""
from srcaco2_tpu_torch.ops import swin_block as sb
from srcaco2_tpu_torch.ops import window_attention as wa


def kernel_wrappers() -> dict:
    """{short name: wrapper} of every kernel, K1-K6."""
    return dict(fwd=sb.swin_block_fwd, bwd=sb.swin_block_bwd,
                pair_fwd=sb.swin_block_pair_fwd,
                pair_bwd=sb.swin_block_pair_bwd,
                grouped=sb.fused_swin_block_grouped,
                wmsa=wa.window_attention)


def launch_counts() -> dict:
    """{short name: launches so far} of every kernel."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}
