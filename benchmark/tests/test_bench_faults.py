"""A run's check on the CPU at a tiny size: sound runs come out correct,
and runs whose timed path is broken underneath come out not correct, as
does the control (the reference in float8 in the program's place). The
look for a card is skipped: execute() is the rest of a run."""
import numpy as np
import pytest
import torch

from benchmark.drivers import serve as S
from benchmark.drivers import train as T
from benchmark.run import execute
from conftest import tiny_cell

CPU = torch.device('cpu')
SEED = 2 ** 32 + 77


def _run(name, seconds=1.0):
    return execute(tiny_cell(name), SEED, seconds, False, CPU, 0.0)


def test_sound_runs_are_correct():
    for name in ('tiny_swinir.train', 'tiny_dbpn.train',
                 'tiny_swinir.serve'):
        out = _run(name)
        assert out['correct'], (name, out['checks'])
        assert out['failed'] == 0 and out['attempted'] > 0


def _frozen_step(orig):
    def step(self, hr, lr, batch):
        keep = {k: v.detach().clone() for k, v in self.state.params.items()}
        holder, ok = orig(self, hr, lr, batch)
        with torch.no_grad():
            for k, v in self.state.params.items():
                v.copy_(keep[k])
        return holder, ok
    return step


def _half_batch_step(orig):
    """The network runs on every row, the loss is the mean over the first
    half of them: the output keeps its shape."""
    from srcaco2_tpu_torch.train import steps
    loss = steps.compute_model_loss

    def half(x):
        return x[:x.shape[0] // 2] if torch.is_tensor(x) and x.ndim else x

    def half_loss(net_type, master, outputs, batch, *args):
        return loss(net_type, master, {k: half(v) for k, v in
                                       outputs.items()},
                    {k: half(v) for k, v in batch.items()}, *args)

    def step(self, hr, lr, batch):
        steps.compute_model_loss = half_loss
        try:
            return orig(self, hr, lr, batch)
        finally:
            steps.compute_model_loss = loss
    return step


@pytest.mark.parametrize('name,fault,number', [
    ('tiny_swinir.train', _frozen_step, 'change_gap'),
    ('tiny_swinir.train', _half_batch_step, 'grad_gap'),
    ('tiny_dbpn.train', _frozen_step, 'change_gap')])
def test_broken_training_step_is_not_correct(monkeypatch, name, fault,
                                             number):
    monkeypatch.setattr(T.Program, 'step', fault(T.Program.step))
    out = _run(name, 0.3)
    assert not out['correct']
    c = out['checks'][number]
    assert c['value'] > c['limit']


def _altered(out):
    out = out.copy()
    out[0] = 255 - out[0]
    return out


def _neighbours(out):
    out = out.copy()
    out[1::2] = out[0::2][:out[1::2].shape[0]]
    return out


@pytest.mark.parametrize('fault', [_altered, _neighbours])
def test_broken_server_is_not_correct(monkeypatch, fault):
    orig = S.Program.__call__
    monkeypatch.setattr(S.Program, '__call__',
                        lambda self, lr: fault(orig(self, lr)))
    cell = tiny_cell('tiny_swinir.serve')
    cell.traffic['sizes'] = [2, 3]     # every request has a neighbour
    out = execute(cell, SEED, 1.0, False, CPU, 0.0)
    assert not out['correct']
    c = out['checks']['image_rms_gap']
    assert c['value'] > c['limit']


@pytest.mark.parametrize('name', ['tiny_swinir.train', 'tiny_dbpn.train'])
def test_training_control_is_not_correct(name):
    cell = tiny_cell(name)
    ref = T.reference_readings(cell, SEED, CPU)
    low = T.reference_readings(cell, SEED, CPU, 'fp8')
    numbers = T.compare(low, ref)
    assert any(numbers[k] > v for k, v in cell.limits.items()), numbers


def test_serving_control_is_not_correct():
    cell = tiny_cell('tiny_swinir.serve')
    params = T.weights(cell, SEED, CPU)
    lr = S.make_pool(cell, SEED, CPU)[:4]
    levels = S.reference_levels(cell, params, CPU, lr)
    low = S.reference_levels(cell, params, CPU, lr, 'fp8')
    served = torch.round(low).to(torch.uint8).numpy()
    gap = max(S.image_gaps(served, levels))
    assert gap > cell.limits['image_rms_gap']
    assert np.isfinite(gap)
