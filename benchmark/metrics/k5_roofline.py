"""K5 (ops/csrc/swin_block_grouped.cu, the grouped block forward of
serving): its share of the roofline, over the traced mean time per
launch, at the server's batch (padding slots included: the kernel
computes them)."""
import re

from benchmark import core

KERNEL = re.compile(r'\bswin_block_grouped_kernel\b')


def read(obs: dict):
    tr, ws = obs['traffic'], obs['cfg']['window_size']
    tile = (2 * ws) ** 2
    return core.roofline_share(obs, 'k5', KERNEL,
                               tr['server_batch'] * tr['lr_side'] ** 2, tile)
