"""DBPN's forward operations."""
from benchmark.counts import conv_flops


def forward_flops(cfg: dict, h: int, w: int) -> int:
    """One h x w LR image through DBPN: the 3x3 and 1x1 feature convs at
    LR; per stage 13 projection units of three k x k convs or transposed
    convs between LR and HR, each nf^2 k^2 multiply-adds per LR pixel
    (counted from the LR side, as the strided conv's outputs or the
    transposed conv's inputs); the compressions (1x1, i nf -> nf) of
    down-units 2-6 at HR and up-units 3-7 at LR; and the last 3x3 conv
    over the stages' HR maps. At nf 64, feat 256, 3 stages, x8 on
    16 x 16: 43.58 GFLOP."""
    nf, feat, r = cfg['base_filter'], cfg['feat'], cfg['scale']
    cin, stages = cfg['in_chans'], cfg['num_stages']
    k = {2: 6, 4: 8, 8: 12}[r]
    lr_px, hr_px = h * w, h * w * r * r
    proj = 13 * 3 * conv_flops(nf, nf, k, lr_px)
    comp = sum(conv_flops(i * nf, nf, 1, hr_px) + conv_flops(i * nf, nf, 1,
                                                             lr_px)
               for i in range(2, 7))
    return (conv_flops(cin, feat, 3, lr_px) + conv_flops(feat, nf, 1, lr_px)
            + stages * (proj + comp)
            + conv_flops(stages * nf, cin, 3, hr_px))
