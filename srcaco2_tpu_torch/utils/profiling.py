"""Profiling and tracing hooks (port of srcaco2_tpu/utils/profiling.py).

`trace_window` records a torch.profiler trace of the CPU and, where a
card is visible, of CUDA, and writes it into `logdir` as a Chrome trace
(`trace_<pid>_<unique>.json`, readable in Perfetto or chrome://tracing);
`annotate` names a span in it; `StepTimer` aggregates per-step wall
times; `device_memory_stats` reads each visible card's allocator
statistics.

Usage:
    with trace_window(logdir, enabled=step in range(100, 110)):
        state, ... = train_step(...)
    timer = StepTimer(); timer.tick() each step; timer.summary()
"""
import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace_window(logdir: str, enabled: bool = True):
    """Profile the block (CPU, and CUDA where a card is visible) and
    write its Chrome trace into `logdir`. Yields the profiler (None when
    not enabled); the trace's path is `prof.trace_file` after the
    block."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
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


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Online per-step wall-time stats with warmup skip."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.n = 0
        self.total = 0.0
        self.best = float('inf')
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.n += 1
            if self.n > self.warmup:
                self.total += dt
                self.best = min(self.best, dt)
        self._last = now

    @property
    def mean(self) -> float:
        counted = max(1, self.n - self.warmup)
        return self.total / counted

    def summary(self, batch_size: Optional[int] = None) -> str:
        s = f'steps={self.n} mean={self.mean * 1e3:.2f}ms ' \
            f'best={self.best * 1e3:.2f}ms'
        if batch_size:
            s += f' throughput={batch_size / self.mean:.1f}/s'
        return s


def device_memory_stats() -> dict:
    """Per-card allocator statistics (bytes and counts,
    torch.cuda.memory_stats), keyed 'cuda:<i>'; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f'cuda:{i}': torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
