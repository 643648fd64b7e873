"""K2 (ops/csrc/swin_block_bwd.cu, the block backward of training: its
window pass and its reduction pass): its share of the roofline, over the
two kernels' traced time per launch, at the cell's batch of patches."""
import re

from benchmark import core

KERNELS = re.compile(r'\bswin_block_bwd_(window|reduce)_kernel\b')
WINDOW = re.compile(r'\bswin_block_bwd_window_kernel\b')


def read(obs: dict):
    side = obs['traffic']['h_size'] // obs['cfg']['scale']
    t = side * side
    return core.roofline_share(obs, 'k2', KERNELS,
                               obs['traffic']['batch'] * t, t, WINDOW)
