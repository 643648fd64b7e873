"""SwinIR's forward operations."""
from benchmark.counts import conv_flops, swin_block_fwd_flops_per_token


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """One h x w LR image through SwinIR: the blocks (above), the 3x3
    convs (the first from the input channels, one per stage and the one
    after the body at C -> C), and the pixelshuffledirect conv to
    scale^2 channels, all at the LR resolution. At C 180, 6 x 6 blocks:
    6.30 GFLOP for 16 x 16, 100.82 GFLOP for 64 x 64."""
    c, ws, r = cfg['embed_dim'], cfg['window_size'], cfg['scale']
    ch = int(c * cfg['mlp_ratio'])
    cin = cfg['in_chans']
    px = h * w
    blocks = sum(cfg['depths']) * px * swin_block_fwd_flops_per_token(
        c, ch, ws)
    convs = (conv_flops(cin, c, 3, px)
             + (len(cfg['depths']) + 1) * conv_flops(c, c, 3, px)
             + conv_flops(c, cin * r * r, 3, px))
    return blocks + convs
