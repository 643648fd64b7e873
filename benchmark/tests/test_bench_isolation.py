"""What a run loads, and where it refuses to run."""
import json
import shutil
import subprocess
import sys

from benchmark import core

RUN = core.BENCH / 'run.py'
DATA = core.BENCH / 'tests' / 'data'


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ('import json, sys, torch\n'
            f'sys.path.insert(0, {str(core.ROOT)!r})\n'
            'from benchmark import core\n'
            'from benchmark.run import execute\n'
            'from benchmark.calibrate import main\n'
            f'spec = core.load_json({str(DATA / "BENCHMARK.json")!r})\n'
            'for name in ("tiny_swinir.train", "tiny_swinir.serve"):\n'
            f'    cell = core.Cell(spec, name, data={str(DATA)!r})\n'
            '    execute(cell, 1, 0.3, True, torch.device("cpu"), 0.0)\n'
            'print(json.dumps(core.forbidden_modules()))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'srcaco2_tpu_torch_like', sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'srcaco2_tpu.models', sys)
    assert core.forbidden_modules() == ['srcaco2_tpu']


def test_no_card_no_result():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    out = subprocess.run([sys.executable, str(RUN), '--workload',
                          'swinir_x8.train.b128', '--seed', '1',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, timeout=300,
                         cwd=core.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copytree(core.BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(core.ROOT / 'BENCHMARK.json', tmp_path)
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'swinir_x8.train.b128', '--seed', '1',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
