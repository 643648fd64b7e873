"""Serving's share of the chip's bf16 peak, in %: the network forward's
operations for every image the traced requests asked for (padding slots
not counted), over the traced window's seconds."""
from benchmark import counts


def read(obs: dict):
    peak, secs = obs.get('peak'), obs.get('traced_s')
    if not peak or not secs or not obs.get('traced_samples'):
        return None
    side = obs['traffic']['lr_side']
    flops = counts.forward_flops(obs['cfg'], side, side) \
        * obs['traced_samples']
    return 100.0 * flops / secs / peak['flops']
