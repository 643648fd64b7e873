"""chip_smoke.py's scheduler of the zoo's entry runs (`_within_budget`),
here with stand-in runs: every net runs once, the needs of the runs on
the card at once stay within the budget, and a run's error is raised."""
import importlib.util
import threading
import time
from pathlib import Path

import pytest


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('budget', [77.0, 40.0, 10.0])
def test_entry_runs_stay_within_budget(budget):
    cs = _chip_smoke()
    need = {nt: cs.zoo_entry_cap_gb(nt) for nt in cs.ZOO}
    lock = threading.Lock()
    running, seen = {}, []

    def run(nt):
        with lock:
            running[nt] = need[nt]
            seen.append((len(running), sum(running.values())))
        time.sleep(0.01)
        with lock:
            del running[nt]
        return nt

    out, most = cs._within_budget(cs.ZOO, need, budget, 4, run)
    assert out == {nt: nt for nt in cs.ZOO}
    assert most == max(n for n, _ in seen) <= 4
    # a run may exceed the budget only alone
    assert all(total <= budget or n == 1 for n, total in seen)


def test_entry_run_error_is_raised():
    cs = _chip_smoke()
    need = {nt: 1.0 for nt in cs.ZOO}

    def run(nt):
        if nt == 'DBPN':
            raise RuntimeError(nt)
        return nt

    with pytest.raises(RuntimeError, match='DBPN'):
        cs._within_budget(cs.ZOO, need, 10.0, 4, run)
