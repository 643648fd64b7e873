"""BENCHMARK.json against the contract the harness keeps: every cell and
metric resolves to its files, and a new cell, traffic mix and metric are
new files and entries only."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core

SPEC = core.load_json(core.ROOT / 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys_and_names():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= SPEC['run_seconds'] <= 51
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ('configs', 'workloads'):
        assert len({x['name'] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC['end_to_end'] + SPEC['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m['unit']) for m in metrics)
    assert any(m['name'] == 'setup_s' for m in SPEC['end_to_end'])
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25


@pytest.mark.parametrize('name', [w['name'] for w in SPEC['workloads']])
def test_cell_resolves_to_its_files(name):
    cell = core.Cell(SPEC, name)
    assert cell.chips == 1
    assert callable(cell.reference().forward)
    assert callable(cell.port().to_port)
    assert callable(cell.driver().run)
    assert set(cell.limits), name
    from benchmark import counts
    side = 16
    assert counts.forward_flops(cell.cfg, side, side) > 0
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer, name
    for m in cell.per_layer:
        assert callable(cell.reader(m['name']))
        assert m['moves'] in e2e, (name, m['name'])


def test_configs_are_files_of_their_own():
    files = [c['file'] for c in SPEC['configs']]
    assert len(set(files)) == len(files)
    for c in SPEC['configs']:
        cfg = core.load_json(core.ROOT / c['file'])
        assert c['file'].startswith('benchmark/')
        assert cfg['reduced'] == c['reduced'] == []


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob('*')) if p.is_file()
            and '__pycache__' not in p.parts}


def test_new_cell_mix_and_metric_are_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell, its limits and a per-layer metric by new files and new entries
    of BENCHMARK.json; the new cell runs on the CPU and reports the new
    metric, and no file of the copy has changed."""
    copy = tmp_path / 'benchmark'
    shutil.copytree(core.BENCH, copy,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digest(copy)
    data = copy / 'tests' / 'data'
    shutil.copy(data / 'configs' / 'tiny_swinir.json',
                copy / 'configs' / 'added_swinir.json')
    shutil.copy(data / 'traffic' / 'tiny_train.json',
                copy / 'traffic' / 'added_train.json')
    shutil.copy(data / 'limits' / 'tiny_swinir.train.json',
                copy / 'limits' / 'added_swinir.train.json')
    (copy / 'metrics' / 'steps_traced.train.py').write_text(
        'def read(obs):\n'
        '    n = obs.get("traced_samples")\n'
        '    return n / obs["traffic"]["batch"] if n else None\n')
    spec = json.loads(json.dumps(SPEC))
    spec['configs'].append(dict(
        name='added_swinir', source='https://arxiv.org/abs/2108.10257',
        file='benchmark/configs/added_swinir.json', reduced=[],
        why='added by files'))
    spec['workloads'].append(dict(
        name='added_swinir.train', config='added_swinir',
        traffic='added_train', chips=1, why='added by files'))
    for m in spec['end_to_end']:
        if m['name'] == 'patches_per_s':
            m['workloads'].append('added_swinir.train')
    spec['per_layer'].append(dict(
        name='steps_traced.train', unit='steps', better='higher',
        source='program_counter', layer='model step', moves='patches_per_s',
        workloads=['added_swinir.train']))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    code = (
        'import json, sys, torch\n'
        f'sys.path[:0] = [{str(tmp_path)!r}, {str(core.ROOT)!r}]\n'
        'from benchmark import core\n'
        'from benchmark.run import execute\n'
        'assert core.BENCH == core.Path(sys.path[0]) / "benchmark"\n'
        'spec = core.load_json(core.Path(sys.path[0]) / "BENCHMARK.json")\n'
        'cell = core.Cell(spec, "added_swinir.train", '
        'root=core.Path(sys.path[0]))\n'
        'out = execute(cell, 5, 0.5, True, torch.device("cpu"), 0.0)\n'
        'print(json.dumps(out))\n')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['correct'], out['checks']
    assert out['metrics']['steps_traced.train']['value'] == 1
    after = _digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        'configs/added_swinir.json', 'traffic/added_train.json',
        'limits/added_swinir.train.json', 'metrics/steps_traced.train.py'}
