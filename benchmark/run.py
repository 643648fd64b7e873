"""The benchmark of srcaco2_tpu_torch on one NVIDIA H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs one cell of BENCHMARK.json (found by name, with its configuration,
traffic mix, limits and metric readers: see core.py) from the root of a
checkout, and prints as its last line of standard output one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`, each number of the
correctness check beside its limit (also the last lines of standard
error). It exits with another code than 0, and prints no result, where
no card is visible or fewer than the cell asks for, where the program's
package is not in the checkout, and where JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import core  # noqa: E402
from benchmark import counts  # noqa: E402


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = None) -> dict:
    """Run the cell on `device` and return its result line as a dict
    (checks last)."""
    import torch
    t_start = T_START if t_start is None else t_start
    res = cell.driver().run(cell, seed, seconds, trace, device, t_start)
    cuda = device.type == 'cuda'
    kind = torch.cuda.get_device_name(device) if cuda else 'cpu'
    dev = dict(platform='gpu' if cuda else 'cpu', kind=kind,
               count=cell.chips if cuda else 1,
               memory_peak_bytes=int(res['memory_peak_bytes']))
    metrics, breakdown = {}, None
    if trace:
        obs = dict(res['obs'], peak=counts.peak(kind), device_kind=kind)
        for m in cell.per_layer:
            value = cell.reader(m['name'])(obs)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        summary = res['obs']['traced']
        dev.update(busy_s=summary['busy_s'], window_s=res['obs']['traced_s'])
        breakdown = dict(device_ops=summary['device_ops'],
                         idle_gaps=res['obs']['host_gaps'])
    else:
        for m in cell.end_to_end:
            metrics[m['name']] = dict(value=res['e2e'][m['name']],
                                      unit=m['unit'])
    checks = {k: dict(value=v, limit=cell.limits[k])
              for k, v in res['checks'].items()}
    correct = (res['failed'] == 0 and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values()))
    out = dict(correct=correct, attempted=res['attempted'],
               failed=res['failed'], metrics=metrics, device=dev)
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['notes'] = res.get('notes', {})
    out['checks'] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    if not (ROOT / 'srcaco2_tpu_torch').is_dir():
        print(f'the program (srcaco2_tpu_torch) is not in {ROOT}',
              file=sys.stderr)
        return 2
    cell = core.Cell(core.load_json(ROOT / 'BENCHMARK.json'), ns.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{ns.workload} needs {cell.chips} CUDA device(s); '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 3
    out = execute(cell, ns.seed, ns.seconds, bool(ns.trace),
                  torch.device('cuda', 0))
    bad = core.forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 4
    for name, c in out['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
