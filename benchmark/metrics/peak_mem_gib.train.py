"""The most device memory the program held at once during the measured
window (torch.cuda.max_memory_allocated after a reset at its start), in
GiB: it sets the batch a card takes."""
from benchmark import counts


def read(obs: dict):
    peak = obs.get('window_peak_bytes')
    return peak / counts.GIB if peak else None
