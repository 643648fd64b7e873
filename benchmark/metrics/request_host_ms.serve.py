"""The server's host work per request that the device cannot overlap, in
ms: the median, over the traced `serve.request` spans, of the request's
ms less those of its `serve.forward` (each batch's enqueue) and
`serve.fetch` (each batch's blocking copy to the host) spans. What is
left is the check of the input, the tail padding, the uploads and the
final join. Read from srcaco2_tpu_torch.utils.profiling's registry,
which records only while a profiler records: in a --trace 1 run, the
device-only traced requests and the host-traced ones (the median keeps
those slower ones out). None where the program records no such span."""
import statistics


def read(obs: dict):
    from srcaco2_tpu_torch.utils import profiling
    if not hasattr(profiling, 'within'):
        return None
    reqs = sorted((s, e) for n, s, e in profiling.records()
                  if n == 'serve.request')
    inside = profiling.within('serve.request',
                              ['serve.forward', 'serve.fetch'])
    ms = [(e - s) * 1e-6 - k for (s, e), k in zip(reqs, inside)]
    return statistics.median(ms) if ms else None
