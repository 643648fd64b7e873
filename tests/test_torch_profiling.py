"""utils/profiling's span and counter registry, and the spans and counters
that the train step and the server record with it: nothing is recorded
while no profiler records; under trace_window each span is a
`user_annotation` around the ops it ran, and the registry's summary is
written beside the trace; `within` sums children by containment; a train
step records its phases once each (the checks twice), a request its
batches, images and slots."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srcaco2_tpu_torch.config.defaults import get_config
from srcaco2_tpu_torch.config.net_defaults import init_net_g
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.inference.serve import SRServer
from srcaco2_tpu_torch.losses.master import build_loss
from srcaco2_tpu_torch.models.registry import define_g
from srcaco2_tpu_torch.train.schedule import build_optimizer
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import make_train_step
from srcaco2_tpu_torch.utils import profiling as PR

PHASES = ('train.step', 'train.assemble', 'train.forward',
          'train.backward', 'train.checks', 'train.optimizer')


@pytest.fixture(autouse=True)
def _empty_registry():
    PR.reset()
    yield
    PR.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _names(records):
    out = {}
    for name, _, _ in records:
        out[name] = out.get(name, 0) + 1
    return out


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def no_record_function(name):
        raise AssertionError(f'record_function({name!r}) while off')

    monkeypatch.setattr(torch.profiler, 'record_function',
                        no_record_function)
    off = PR.span('a')
    for i in range(1000):
        with PR.span(f'a{i % 3}') as s:
            assert s is off
        PR.count('n', i)
    assert PR.records() == [] and PR.counters() == {}
    assert PR.within('a0', ['a1']) == []


def test_trace_window_records_spans_around_their_ops(tmp_path):
    with PR.span('before'):
        pass
    with PR.trace_window(str(tmp_path)) as prof:
        with PR.span('outer'):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
            with PR.span('inner'):
                torch.ones(8).add(1.0)
            PR.count('n', 3)
        PR.count('n')
    assert _names(PR.records()) == {'outer': 1, 'inner': 1}
    assert PR.counters() == {'n': 4}
    assert PR.within('outer', ['inner'])[0] > 0
    events = json.load(open(prof.trace_file))['traceEvents']

    def one(name, cat):
        found = [e for e in events if e.get('name') == name
                 and e.get('cat') == cat and e.get('ph') == 'X']
        assert len(found) == 1, (name, cat, len(found))
        return float(found[0]['ts']), float(found[0]['ts']) + float(
            found[0]['dur'])

    outer, inner = one('outer', 'user_annotation'), \
        one('inner', 'user_annotation')
    mm, add = one('aten::mm', 'cpu_op'), one('aten::add', 'cpu_op')
    assert outer[0] <= mm[0] and mm[1] <= outer[1]
    assert inner[0] <= add[0] and add[1] <= inner[1]
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert not inner[0] <= mm[0] <= inner[1]
    assert os.path.dirname(prof.spans_file) == str(tmp_path)
    assert os.path.basename(prof.spans_file) == \
        'spans_' + os.path.basename(prof.trace_file)[len('trace_'):]
    spans = json.load(open(prof.spans_file))
    assert {k: v['count'] for k, v in spans['spans'].items()} == \
        {'outer': 1, 'inner': 1}
    assert spans['spans']['outer']['total_ms'] >= \
        spans['spans']['inner']['median_ms'] > 0
    assert spans['counters'] == {'n': 4}
    assert spans['device_idle_by_span'] == {}     # no device on the CPU


def test_within_sums_children_by_containment():
    reg = PR.Registry()
    ms = 1_000_000
    reg._spans.extend([
        ('kid', 10 * ms, 20 * ms), ('kid', 30 * ms, 50 * ms),
        ('other', 60 * ms, 70 * ms),
        ('kid', 90 * ms, 110 * ms),          # crosses the parent's end
        ('parent', 0, 100 * ms),
        ('kid', 210 * ms, 260 * ms), ('other', 270 * ms, 275 * ms),
        ('parent', 200 * ms, 300 * ms),
        ('parent', 400 * ms, 500 * ms)])
    assert reg.within('parent', ['kid']) == pytest.approx([30, 50, 0])
    assert reg.within('parent', 'kid') == pytest.approx([30, 50, 0])
    assert reg.within('parent', ['kid', 'other']) == \
        pytest.approx([40, 55, 0])
    assert reg.within('none', ['kid']) == []
    summ = reg.summary()
    assert summ['spans']['parent'] == dict(
        count=3, total_ms=pytest.approx(300), median_ms=pytest.approx(100))


def test_device_idle_by_span_follows_the_gap_rule():
    """Gaps between the union of the device's events, each summed under
    the innermost span of the registry's names running as it began."""
    reg = PR.Registry()
    reg._spans.extend([('step', 0, 1), ('opt', 0, 1)])

    def ev(name, cat, ts, dur):
        return dict(ph='X', name=name, cat=cat, ts=ts, dur=dur)

    events = [ev('step', 'user_annotation', 0, 100),
              ev('opt', 'user_annotation', 50, 30),
              ev('bench.x', 'user_annotation', 0, 120),     # not a span
              ev('aten::add', 'cpu_op', 55, 2),
              ev('k', 'kernel', 10, 30),          # busy 10-40
              ev('k', 'kernel', 20, 5),
              ev('c', 'gpu_memcpy', 60, 10),      # gap 40-60: step
              ev('s', 'gpu_memset', 75, 10),      # gap 70-75: opt
              ev('k', 'kernel', 105, 5)]          # gap 85-105: step
    gaps = reg.summary(events)['device_idle_by_span']
    # 0-10 under step, 110-120 (to the last host event) under no span
    assert gaps == pytest.approx({'step': 50e-6, 'opt': 5e-6,
                                  'no span': 10e-6})


def _tiny_args(h_size):
    args = {'scale': 2, 'n_channels': 1, 'h_size': h_size, 'amp': False}
    netG = init_net_g({'net_type': 'SwinIR'}, args)
    netG.update(swinir_window_size=4, swinir_embed_dim=16,
                swinir_depths=[2], swinir_num_heads=[2],
                swinir_upsampler='pixelshuffledirect')
    args['netG'] = netG
    return args


@pytest.mark.parametrize('k', [1, 2])
def test_train_step_records_its_phases(k):
    torch.manual_seed(0)
    args = {**get_config(), **_tiny_args(16), 'l2': True}
    model = define_g(args, 'cpu').train()
    tx = build_optimizer(args['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    cfg = P.PipeConfig(scale=2, h_size=16)
    step = make_train_step(model, build_loss(args), tx, 'SwinIR', cfg,
                           steps_per_call=k)
    g = torch.Generator().manual_seed(1)
    hr = torch.randint(0, 256, (3, 32, 32, 1), dtype=torch.uint8,
                       generator=g)
    lr = torch.randint(0, 256, (3, 16, 16, 1), dtype=torch.uint8,
                       generator=g)

    def call(state):
        if k == 1:
            return step(state, hr, lr, torch.tensor([0, 2]),
                        P.draw(g, 2, cfg, (32, 32)))
        return step(state, hr, lr, torch.tensor([[0, 2]] * k),
                    [P.draw(g, 2, cfg, (32, 32)) for _ in range(k)])

    state = call(state)[0]
    assert PR.records() == []
    with _recording():
        state, _, ok = call(state)
    assert bool(ok)
    recs = PR.records()
    assert _names(recs) == {'train.step': k, 'train.assemble': k,
                            'train.forward': k, 'train.backward': k,
                            'train.checks': 2 * k, 'train.optimizer': k}
    steps = sorted((s, e) for n, s, e in recs if n == 'train.step')
    for n, s, e in recs:        # each phase inside one step
        assert n == 'train.step' or any(a <= s and e <= b
                                        for a, b in steps), n
    kids = PR.within('train.step', PHASES[1:])
    assert len(kids) == k
    for (s, e), ms in zip(steps, kids):
        assert 0 < ms <= (e - s) * 1e-6
    assert all(ms > 0 for ms in PR.within('train.step', 'train.checks'))


def test_server_counts_images_and_slots():
    args = _tiny_args(32)
    model = define_g(args, 'cpu')
    srv = SRServer(args=args, state_dict=model.state_dict(), batch_size=8,
                   lr_hw=(16, 16), device='cpu')
    x = np.random.default_rng(0).integers(0, 256, (9, 1, 16, 16),
                                          dtype=np.uint8)
    want = srv(x)
    assert PR.records() == [] and PR.counters() == {}
    with _recording():
        got = srv(x)
    np.testing.assert_array_equal(got, want)
    assert PR.counters() == {'serve.images': 9, 'serve.slots': 16}
    assert _names(PR.records()) == {'serve.request': 1, 'serve.forward': 2,
                                    'serve.fetch': 2}
    (inside,) = PR.within('serve.request', ['serve.forward', 'serve.fetch'])
    (name, s, e), = [r for r in PR.records() if r[0] == 'serve.request']
    assert 0 < inside <= (e - s) * 1e-6
