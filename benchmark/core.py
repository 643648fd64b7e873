"""The harness's general parts: finding a cell's files by name, seeds,
statistics, the reduction of a profiler trace, and the guard against the
JAX package.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
configuration's file is the one BENCHMARK.json gives; its `arch` names
the plain reference (`reference/<arch>.py`) and the program's adapter
(`ports/<arch>.py`). The traffic mix is `traffic/<traffic>.json`, whose
`kind` names the driver (`drivers/<kind>.py`). The limits of the cell's
correctness check are `limits/<cell>.json`, and each per-layer metric is
read by `metrics/<metric>.py`. Adding a cell, a mix or a metric adds
files and entries and edits none.
"""
import bisect
import hashlib
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'srcaco2_tpu')


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with everything it names, loaded."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT,
                 data: Path = BENCH):
        """`root` is where the configuration files' paths start, `data`
        the directory of `traffic/` and `limits/`."""
        cells = {w['name']: w for w in spec['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r} (workloads: '
                           f'{", ".join(cells)})')
        self.name, self.entry = name, cells[name]
        configs = {c['name']: c for c in spec['configs']}
        self.cfg = load_json(Path(root) / configs[self.entry['config']]
                             ['file'])
        self.traffic = load_json(Path(data) / 'traffic'
                                 / f'{self.entry["traffic"]}.json')
        self.limits = load_json(Path(data) / 'limits' / f'{name}.json')
        self.end_to_end = [m for m in spec['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in spec['per_layer']
                          if name in m.get('workloads', [name])]

    @property
    def chips(self) -> int:
        return int(self.entry['chips'])

    def reference(self):
        return importlib.import_module(
            f'benchmark.reference.{self.cfg["arch"]}')

    def port(self):
        return importlib.import_module(f'benchmark.ports.{self.cfg["arch"]}')

    def driver(self):
        return importlib.import_module(
            f'benchmark.drivers.{self.traffic["kind"]}')

    def reader(self, metric: str):
        """The `read(obs)` of metrics/<metric>.py (a name may hold dots,
        so the file is loaded by its path)."""
        path = BENCH / 'metrics' / f'{metric}.py'
        mod_name = 'benchmark_metric_' + metric.replace('.', '_')
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each named stream of a run's seed."""
    h = hashlib.sha256(f'{int(seed)}:{stream}'.encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks
    (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    if lo == pos:
        return float(xs[lo])
    return float(xs[lo] + (xs[lo + 1] - xs[lo]) * (pos - lo))


class Marks:
    """Seconds between named points of a run's set-up."""

    def __init__(self, t_start: float):
        self.t, self.phases = t_start, {}

    def __call__(self, name: str):
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (the program's own package name begins with
    the JAX package's)."""
    tops = {m.split('.')[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ------------------------------------------------------------------ trace

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, starts, t: float, reach: int = 4000):
    """The name of the latest-started of `spans` (sorted by start) that
    is still running at time t: of properly nested spans, the innermost."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(spans[max(0, i - reach):i]):
        if e >= t:
            return name
    return None


def _host_label(ops, marks, t: float) -> str:
    """The harness's span and the innermost host op running at time t."""
    parts = [_innermost(*marks, t), _innermost(*ops, t)]
    return ' / '.join(x for x in parts if x) or 'no host op'


def summarize_events(events: list, top: int = 10) -> dict:
    """From a Chrome trace's events: the device's busy seconds (the union
    of its kernels, copies and sets), the traced span, the time and
    launches of every kernel by name, the `top` device operations by
    time, and the idle time between device activity summed by what the
    host was doing when each gap began."""
    dev, host = [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        s, e = float(ev['ts']), float(ev['ts']) + float(ev['dur'])
        cat = ev.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((ev['name'], cat, s, e))
        elif cat in HOST_CATS:
            host.append((ev['name'], cat, s, e))
    if not dev:
        return dict(busy_s=0.0, span_s=0.0, kernels={}, device_ops=[],
                    idle_gaps=[])
    host.sort(key=lambda h: h[2])

    def index(keep):
        spans = [(n, s, e) for n, c, s, e in host if keep(n, c)]
        return spans, [x[1] for x in spans]

    ops = index(lambda n, c: c == 'cpu_op')
    marks = index(lambda n, c: c == 'user_annotation'
                  and n.startswith('bench.'))
    t0 = min([d[2] for d in dev] + [h[2] for h in host])
    t1 = max([d[3] for d in dev] + [h[3] for h in host])
    busy = _union([(s, e) for _, _, s, e in dev])
    kernels = {}
    for name, cat, s, e in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-6
        k[1] += 1
    gaps, prev = {}, t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            label = _host_label(ops, marks, prev)
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    top_ops = sorted(((n[:160], v[0]) for n, v in kernels.items()),
                     key=lambda x: -x[1])[:top]
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6,
                span_s=(t1 - t0) * 1e-6,
                kernels={n: tuple(v) for n, v in kernels.items()},
                device_ops=[list(x) for x in top_ops],
                idle_gaps=[list(x) for x in sorted(
                    gaps.items(), key=lambda x: -x[1])[:top]])


class Traced:
    """torch.profiler over a block: the device alone (its kernels,
    copies and sets, traced by CUPTI at little cost to the host), or with
    `host` the host's ops too, which slows a host-bound step. After the
    block, `summary` holds summarize_events of its trace. The trace goes
    to a temporary file that is removed once read."""

    def __init__(self, device, host: bool = False):
        self.device, self.host = device, host
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts or [ProfilerActivity.CPU])
        self.prof.start()
        return self

    def __exit__(self, *exc):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(path)
        self.summary = summarize_events(events)
        return False


def span(name: str):
    """A named host span of the harness (seen by the traced run only)."""
    import torch
    return torch.profiler.record_function(f'bench.{name}')


def kernel_time(kernels: dict, pattern) -> tuple:
    """(seconds, launches) of the traced kernels whose name matches the
    regular expression `pattern`."""
    secs = launches = 0
    for name, (s, n) in kernels.items():
        if pattern.search(name):
            secs += s
            launches += n
    return secs, launches


def roofline_share(obs: dict, kernel: str, pattern, tokens: int, t: int,
                   launch_pattern=None):
    """A kernel's share of its roofline in %: the least time of one
    launch's operations and bytes (counts.swin_kernel_work) at the
    chip's peaks, over the traced mean time per launch of the kernels
    matching `pattern`, launches counted by `launch_pattern` (default
    the same). None where the trace or the peaks are missing or the
    kernel did not run."""
    from benchmark import counts
    peak, traced = obs.get('peak'), obs.get('traced')
    if not peak or not traced:
        return None
    secs, n = kernel_time(traced['kernels'], pattern)
    if launch_pattern is not None:
        n = kernel_time(traced['kernels'], launch_pattern)[1]
    if n == 0 or secs <= 0:
        return None
    flops, nbytes = counts.swin_kernel_work(kernel, obs['cfg'], tokens, t)
    bound = max(flops / peak['flops'], nbytes / peak['bytes_per_s'])
    return 100.0 * bound / (secs / n)
