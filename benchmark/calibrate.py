"""Readings that set the limits of a cell's correctness check. Runs on
the card; one JSON line per reading, and all of them in --out.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        --what program,control,half [--seconds 4] [--out FILE]

`program` reads the cell's numbers for the program against the float32
reference on each seed (the lower readings), `control` for the reference
with its activations and products' operands in float8 in the program's
place, and `half` (training) for the reference whose loss is the mean
over half of each batch's rows, the network run on all of them. A
serving reading serves a window of --seconds and compares the same
sample as a run.
"""
import argparse
import contextlib
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import core  # noqa: E402
from benchmark.drivers import serve as S  # noqa: E402
from benchmark.drivers import train as T  # noqa: E402
from benchmark.reference import common as RC  # noqa: E402


def leaf_gaps(prog: dict, ref: dict, key: str) -> dict:
    """Quantiles of the per-leaf gaps of `key` (as compare() measures
    them), and the three worst leaves."""
    med = statistics.median(ref[key].values())
    gaps = sorted(((abs(prog[key][k] - r) / max(r, med), k)
                   for k, r in ref[key].items()), reverse=True)
    vals = [g for g, _ in gaps]
    return dict(median=statistics.median(vals),
                p90=vals[len(vals) // 10], worst=gaps[:3])


def train_readings(cell, seeds, what, device):
    prog = T.Program(cell, device) if 'program' in what else None
    beta1 = float(cell.cfg['train']['optimizer']['beta1'])
    n = int(cell.traffic['checked_steps'])
    for seed in seeds:
        t0 = time.perf_counter()
        ref = T.reference_readings(cell, seed, device)
        t_ref = time.perf_counter() - t0
        sides = {}
        if prog is not None:
            prog.start(T.weights(cell, seed, device))
            hr, lr = T.make_stacks(cell, seed, device)
            # a float32 program as a witness: true float32, as the
            # reference (TF32 off)
            with (RC.true_f32() if cell.cfg['compute_dtype'] == 'float32'
                  else contextlib.nullcontext()):
                sides['program'] = T.program_readings(
                    prog, hr, lr, T.Draws(cell, seed, device), n, beta1)
            del hr, lr
        if 'control' in what:
            sides['control'] = T.reference_readings(cell, seed, device,
                                                    'fp8')
        if 'half' in what:
            sides['half'] = T.reference_readings(cell, seed, device,
                                                 rows=0.5)
        for side, r in sides.items():
            yield dict(seed=seed, side=side, **T.compare(r, ref),
                       dtype=cell.cfg['compute_dtype'],
                       grad_leaves=leaf_gaps(r, ref, 'grad'),
                       change_leaves=leaf_gaps(r, ref, 'change'),
                       loss=r['loss'], ref_loss=ref['loss'],
                       reference_s=t_ref)


def serve_readings(cell, seeds, what, seconds, device):
    tr = cell.traffic
    for seed in seeds:
        prog = S.Program(cell, seed, device)
        pool = S.make_pool(cell, seed, device)
        reqs = S.Requests(tr, seed, 'requests')
        lat, sizes, _, _, kept = S.serve_window(prog, pool, reqs, seconds,
                                                keep=True)
        sample = S.check_sample(sizes, tr, seed)
        del prog
        params = T.weights(cell, seed, device)
        sides = {k: [] for k in what}
        t0 = time.perf_counter()
        for i in sample:
            lr = np.take(pool, reqs[i][1], axis=0)
            levels = S.reference_levels(cell, params, device, lr)
            if 'program' in what:
                sides['program'] += S.image_gaps(kept[i], levels)
            if 'control' in what:
                low = S.reference_levels(cell, params, device, lr, 'fp8')
                served = torch.round(low).to(torch.uint8).cpu().numpy()
                sides['control'] += S.image_gaps(served, levels)
        t_ref = time.perf_counter() - t0
        for side, gaps in sides.items():
            yield dict(seed=seed, side=side, image_rms_gap=max(gaps),
                       median_image_gap=statistics.median(gaps),
                       images=len(gaps), requests=len(sizes),
                       p95_ms=core.percentile(lat, 95) * 1e3,
                       reference_s=t_ref)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='1,2,3')
    ap.add_argument('--what', default='program,control,half')
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--program-dtype', help='run the program in this '
                    'compute dtype instead of the configuration\'s (a '
                    'witness: float32)')
    ap.add_argument('--out')
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    from srcaco2_tpu_torch.ops.build import build_all
    build_all()
    cell = core.Cell(core.load_json(ROOT / 'BENCHMARK.json'), ns.workload)
    if ns.program_dtype:
        cell.cfg['compute_dtype'] = ns.program_dtype
    seeds = [int(s) for s in ns.seeds.split(',') if s]
    what = ns.what.split(',')
    if cell.traffic['kind'] == 'train':
        rows = train_readings(cell, seeds, what, device)
    else:
        rows = serve_readings(cell, seeds, what, ns.seconds, device)
    out = []
    for row in rows:
        row = dict(workload=ns.workload, **row)
        print(json.dumps(row), flush=True)
        out.append(row)
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text('\n'.join(json.dumps(r) for r in out)
                                + '\n')
    bad = core.forbidden_modules()
    if bad:
        print(f'loaded: {bad}', file=sys.stderr)
        return 4
    return 0 if all(math.isfinite(r.get('loss_gap', 0.0)) for r in out) \
        else 1


if __name__ == '__main__':
    sys.exit(main())
