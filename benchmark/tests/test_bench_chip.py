"""On the card: every cell of BENCHMARK.json runs correct at its own
size, and its control (the reference in float8 in the program's
place) comes out not correct there. Skips where no card is visible."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.drivers import serve as S
from benchmark.drivers import train as T

SPEC = core.load_json(core.ROOT / 'BENCHMARK.json')
CELLS = [w['name'] for w in SPEC['workloads']]
SEED = 2 ** 31 + 909


@pytest.mark.chip
@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          name, '--seed', str(SEED), '--seconds', '3',
                          '--trace', '0'], capture_output=True, text=True,
                         timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'], res['checks']
    assert res['device']['platform'] == 'gpu'


@pytest.mark.chip
@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(card, name):
    cell = core.Cell(SPEC, name)
    if cell.traffic['kind'] == 'train':
        ref = T.reference_readings(cell, SEED, card)
        numbers = T.compare(T.reference_readings(cell, SEED, card, 'fp8'),
                            ref)
        assert any(numbers[k] > v for k, v in cell.limits.items()), numbers
        return
    params = T.weights(cell, SEED, card)
    lr = S.make_pool(cell, SEED, card)[:cell.traffic['sizes'][1]]
    levels = S.reference_levels(cell, params, card, lr)
    low = S.reference_levels(cell, params, card, lr, 'fp8')
    gap = max(S.image_gaps(torch.round(low).to(torch.uint8).cpu().numpy(),
                           levels))
    assert np.isfinite(gap) and gap > cell.limits['image_rms_gap']
