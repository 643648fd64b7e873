"""The training step's share of the chip's bf16 peak, in %: three times
the network forward's operations for every patch of the traced steps
(forward and backward; recomputation not counted), over the traced
window's seconds."""
from benchmark import counts


def read(obs: dict):
    peak, secs = obs.get('peak'), obs.get('traced_s')
    if not peak or not secs or not obs.get('traced_samples'):
        return None
    side = obs['traffic']['h_size'] // obs['cfg']['scale']
    flops = 3 * counts.forward_flops(obs['cfg'], side, side) \
        * obs['traced_samples']
    return 100.0 * flops / secs / peak['flops']
