"""The readers of the program's spans and counters (`source`
program_span / program_counter): on the CPU tiny cells, with the five
metrics added to a copy of the tiny spec, a --trace 1 run reports each
of them from the registry of srcaco2_tpu_torch.utils.profiling; the
padding share equals a count of the traced requests' padding; a run
without tracing leaves the registry empty."""
import json
import math

import pytest
import torch

from benchmark import core
from benchmark.drivers import serve as S
from benchmark.run import execute
from conftest import DATA

CPU = torch.device('cpu')
SEED = 2 ** 31 + 4242
CELLS = {'swinir_x8.train.b128': 'tiny_swinir.train',
         'swinir_x8.serve.mix': 'tiny_swinir.serve'}
READERS = ('step_host_ms.train', 'optimizer_host_ms.train',
           'checks_host_ms.train', 'request_host_ms.serve',
           'pad_share.serve')


def _spec() -> dict:
    """The tiny spec with the benchmark's entries of the five metrics,
    their cells renamed to the tiny ones."""
    spec = core.load_json(DATA / 'BENCHMARK.json')
    for m in core.load_json(core.ROOT / 'BENCHMARK.json')['per_layer']:
        if m['name'] in READERS:
            m = json.loads(json.dumps(m))
            m['workloads'] = [CELLS[w] for w in m['workloads']]
            spec['per_layer'].append(m)
    return spec


def _profiling():
    from srcaco2_tpu_torch.utils import profiling
    profiling.reset()
    return profiling


@pytest.fixture(scope='module')
def train_run():
    prof = _profiling()
    out = execute(core.Cell(_spec(), 'tiny_swinir.train', data=DATA), SEED,
                  0.5, True, CPU, 0.0)
    return out, prof.records()


@pytest.fixture(scope='module')
def serve_run():
    prof = _profiling()
    sizes = []
    call = S.Program.__call__

    def counted(self, lr_u8):
        if torch.autograd.profiler._is_profiler_enabled:
            sizes.append(lr_u8.shape[0])
        return call(self, lr_u8)

    S.Program.__call__ = counted
    try:
        cell = core.Cell(_spec(), 'tiny_swinir.serve', data=DATA)
        out = execute(cell, SEED, 0.5, True, CPU, 0.0)
    finally:
        S.Program.__call__ = call
    return out, prof.counters(), sizes, cell.traffic['server_batch']


def test_all_five_are_in_the_benchmark():
    names = {m['name']: m for m in
             core.load_json(core.ROOT / 'BENCHMARK.json')['per_layer']}
    for r in READERS:
        assert names[r]['source'] in ('program_span', 'program_counter')
        assert set(names[r]['workloads']) <= set(CELLS)


def test_train_readers(train_run):
    out, recs = train_run
    assert out['correct'], out['checks']
    m = {k: v['value'] for k, v in out['metrics'].items()}
    for r in READERS[:3]:
        assert math.isfinite(m[r]) and m[r] > 0, r
    assert m['optimizer_host_ms.train'] + m['checks_host_ms.train'] <= \
        m['step_host_ms.train']
    # the tiny mix traces 1 device-only step and 1 host-traced step
    assert sum(n == 'train.step' for n, _, _ in recs) == 2
    assert 'request_host_ms.serve' not in m


def test_serve_readers(serve_run):
    out, counters, sizes, batch = serve_run
    assert out['correct'], out['checks']
    m = {k: v['value'] for k, v in out['metrics'].items()}
    for r in READERS[3:]:
        assert math.isfinite(m[r]), r
    assert m['request_host_ms.serve'] > 0
    slots = sum(-(-n // batch) * batch for n in sizes)
    assert sizes and counters == {'serve.images': sum(sizes),
                                  'serve.slots': slots}
    assert m['pad_share.serve'] == pytest.approx(
        100.0 * (slots - sum(sizes)) / slots)
    assert 'step_host_ms.train' not in m


def test_untraced_run_records_nothing():
    prof = _profiling()
    out = execute(core.Cell(_spec(), 'tiny_swinir.serve', data=DATA), SEED,
                  0.3, False, CPU, 0.0)
    assert out['correct'], out['checks']
    assert prof.records() == [] and prof.counters() == {}
