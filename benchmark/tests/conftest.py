"""The benchmark's own tests. `chip` marks the tests that need an NVIDIA
card; they skip elsewhere, deciding inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / 'data'


def pytest_configure(config):
    config.addinivalue_line('markers', 'chip: needs an NVIDIA card (skips '
                            'elsewhere)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)


def tiny_cell(name: str):
    from benchmark import core
    spec = core.load_json(DATA / 'BENCHMARK.json')
    return core.Cell(spec, name, data=DATA)
