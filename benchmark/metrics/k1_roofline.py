"""K1 (ops/csrc/swin_block_fwd.cu, the block forward of training): its
share of the roofline, over the traced mean time per launch, at the
cell's batch of patches."""
import re

from benchmark import core

KERNEL = re.compile(r'\bswin_block_fwd_kernel\b')


def read(obs: dict):
    side = obs['traffic']['h_size'] // obs['cfg']['scale']
    t = side * side
    return core.roofline_share(obs, 'k1', KERNEL,
                               obs['traffic']['batch'] * t, t)
