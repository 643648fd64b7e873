"""Profiling and tracing hooks (port of srcaco2_tpu/utils/profiling.py):
the program's span and counter registry, and `trace_window`.

`span(name)` names a phase of the program and `count(name, n)` adds to a
counter. Both record only while a torch.profiler records: otherwise
`span` returns one shared no-op object after a single flag read, and
`count` returns. While a profiler records, a span opens
`torch.profiler.record_function(name)`, so the trace shows it as a
`user_annotation` around the ops and kernels it launched, on the
profiler's own clock, and appends (name, start_ns, end_ns) on
`time.perf_counter_ns` to a bounded ring. Nothing here reads a device
value or synchronises: a span measures the host's time, which is the
time to enqueue the work wherever the code makes no sync.

`records()`, `counters()` and `reset()` read and clear the registry;
`within(parent, children)` gives, per occurrence of `parent`, the ms of
the `children` spans that lie inside it.

`trace_window` records a torch.profiler trace of the CPU and, where a
card is visible, of CUDA, and writes it into `logdir` as a Chrome trace
(`trace_<pid>_<unique>.json`, readable in Perfetto or chrome://tracing)
with the registry's summary beside it (`spans_<pid>_<unique>.json`).

Usage:
    with trace_window(logdir, enabled=step in range(100, 110)):
        state, ... = train_step(...)
"""
import bisect
import collections
import contextlib
import json
import os
import statistics
import tempfile
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 16              # spans kept; the oldest go first
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')


class _Off:
    """The span of a process that no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('ring', 'name', 'rf', 't0')

    def __init__(self, ring, name: str):
        self.ring, self.name = ring, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.ring.append((self.name, self.t0, t1))
        return False


class Registry:
    """Spans and counters of one process, recorded while a profiler
    records (see the module's docstring)."""

    def __init__(self):
        self._spans = collections.deque(maxlen=RING)
        self._counters = {}
        self._lock = threading.Lock()

    def span(self, name: str):
        """The span `name` while a profiler records, else the shared
        no-op context manager."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self._spans, name)

    def count(self, name: str, n: int = 1):
        """Add n (a host int) to the counter `name` while a profiler
        records."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def records(self) -> list:
        """The recorded spans, (name, start_ns, end_ns), in the order
        they ended."""
        return list(self._spans)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def reset(self):
        self._spans.clear()
        with self._lock:
            self._counters.clear()

    def within(self, parent: str, children) -> list:
        """Per occurrence of the span `parent`, in the order they
        started: the summed ms of the spans named in `children` (a name
        or names) that start and end inside it."""
        names = {children} if isinstance(children, str) else set(children)
        spans = self.records()
        kids = sorted((s, e) for n, s, e in spans if n in names)
        starts = [s for s, _ in kids]
        out = []
        for s, e in sorted((s, e) for n, s, e in spans if n == parent):
            i = bisect.bisect_left(starts, s)
            j = bisect.bisect_right(starts, e)
            out.append(sum(ke - ks for ks, ke in kids[i:j] if ke <= e)
                       * 1e-6)
        return out

    def summary(self, events: list = None) -> dict:
        """The registry per span name (count, total and median ms) and its
        counters; given a Chrome trace's events recorded with it, also
        `device_idle_by_span`: the device's idle seconds in the trace, summed
        by the innermost span of the registry's names that was running as
        each gap began ('no span' where none was). A gap is the time from
        the end of the device's activity (the union of its kernels, copies
        and sets) to its next start, over the trace's first to last event;
        the spans are the trace's `user_annotation` events, on the device
        events' clock."""
        by_name = collections.defaultdict(list)
        for name, s, e in self.records():
            by_name[name].append((e - s) * 1e-6)
        out = dict(spans={n: dict(count=len(v), total_ms=sum(v),
                                  median_ms=statistics.median(v))
                          for n, v in sorted(by_name.items())},
                   counters=self.counters())
        if events is not None:
            out['device_idle_by_span'] = _idle_by_span(events, set(by_name))
        return out


_REGISTRY = Registry()
span = _REGISTRY.span
count = _REGISTRY.count
records = _REGISTRY.records
counters = _REGISTRY.counters
reset = _REGISTRY.reset
within = _REGISTRY.within
summary = _REGISTRY.summary


def _idle_by_span(events: list, names: set) -> dict:
    dev, marks, ends = [], [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        s = float(ev['ts'])
        e = s + float(ev['dur'])
        cat = ev.get('cat', '')
        if cat in DEVICE_CATS:
            dev.append((s, e))
        elif cat in HOST_CATS:
            ends += [s, e]
            if cat == 'user_annotation' and ev.get('name') in names:
                marks.append((s, e, ev['name']))
    if not dev:
        return {}
    dev.sort()
    marks.sort()
    t1 = max(max(e for _, e in dev), max(ends, default=0.0))
    prev = min(dev[0][0], min(ends, default=dev[0][0]))
    gaps, open_, k = {}, [], 0
    for s, e in dev + [(t1, t1)]:
        if s > prev:
            # the spans started by prev, still running at prev: nested
            # spans end in the reverse order of their starts
            while k < len(marks) and marks[k][0] <= prev:
                open_.append(marks[k])
                k += 1
            while open_ and open_[-1][1] < prev:
                open_.pop()
            label = open_[-1][2] if open_ else 'no span'
            gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    return gaps


@contextlib.contextmanager
def trace_window(logdir: str, enabled: bool = True):
    """Profile the block (CPU, and CUDA where a card is visible) and
    write its Chrome trace into `logdir`. Yields the profiler (None when
    not enabled); after the block the trace's path is `prof.trace_file`.

    The registry is cleared as the window opens, so it holds the
    window's spans and counters alone. Beside the trace,
    `prof.spans_file` (`spans_` in place of the trace's `trace_`) holds
    summary(): each span's count, total and median ms, the counters, and
    the device's idle seconds by the program span that was running as
    each gap began. That file says in the program's own terms why the
    device sat idle; the trace's op names alone do not."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        fd, prof.trace_file = tempfile.mkstemp(
            prefix=f'trace_{os.getpid()}_', suffix='.json', dir=logdir)
        os.close(fd)
        prof.export_chrome_trace(prof.trace_file)
        with open(prof.trace_file) as f:
            events = json.load(f)['traceEvents']
        base = os.path.basename(prof.trace_file)
        prof.spans_file = os.path.join(logdir,
                                      'spans_' + base[len('trace_'):])
        with open(prof.spans_file, 'w') as f:
            json.dump(summary(events), f, indent=1)
