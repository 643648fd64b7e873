"""The host's ms of the optimizer per training step: the median, over
the traced `train.step` spans, of the `train.optimizer` span inside each
(the optimizer chain, the masked update of the parameters and the EMA).
Read from srcaco2_tpu_torch.utils.profiling's registry, which records
only while a profiler records (see step_host_ms.train). None where the
program records no such span."""
import statistics


def read(obs: dict):
    from srcaco2_tpu_torch.utils import profiling
    if not hasattr(profiling, 'within'):
        return None
    ms = profiling.within('train.step', ['train.optimizer'])
    return statistics.median(ms) if ms else None
