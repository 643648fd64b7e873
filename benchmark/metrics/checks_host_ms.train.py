"""The host's ms of the finite checks per training step: the median,
over the traced `train.step` spans, of the two `train.checks` spans
inside each, summed (the check of the loss and grads with the mask it
drives, and the check of the new parameters). Read from
srcaco2_tpu_torch.utils.profiling's registry, which records only while a
profiler records (see step_host_ms.train). None where the program
records no such span."""
import statistics


def read(obs: dict):
    from srcaco2_tpu_torch.utils import profiling
    if not hasattr(profiling, 'within'):
        return None
    ms = profiling.within('train.step', ['train.checks'])
    return statistics.median(ms) if ms else None
