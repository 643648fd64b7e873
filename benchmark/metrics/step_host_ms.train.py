"""The host's ms per training step: the median, over the traced steps,
of the program's `train.step` span. The spans come from the registry of
srcaco2_tpu_torch.utils.profiling, which records only while a profiler
records: in a --trace 1 run, the device-only traced steps and the one
host-traced step (the median keeps that slower one out). None where the
program records no such span."""
import statistics


def read(obs: dict):
    from srcaco2_tpu_torch.utils import profiling
    if not hasattr(profiling, 'records'):
        return None
    ms = [(e - s) * 1e-6 for n, s, e in profiling.records()
          if n == 'train.step']
    return statistics.median(ms) if ms else None
