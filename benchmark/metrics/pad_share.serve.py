"""The share of the server's batch slots, in %, that held padding in the
traced requests: 100 x (slots - images) / slots, from the program's
counters `serve.slots` (each batch's slots) and `serve.images` (the
images the batch was asked for). Read from
srcaco2_tpu_torch.utils.profiling's registry, which records only while a
profiler records: the traced requests of a --trace 1 run. None where the
program counts no slots."""


def read(obs: dict):
    from srcaco2_tpu_torch.utils import profiling
    if not hasattr(profiling, 'counters'):
        return None
    c = profiling.counters()
    slots = c.get('serve.slots', 0)
    if not slots:
        return None
    return 100.0 * (slots - c.get('serve.images', 0)) / slots
