"""The evaluation sweep: every trained experiment under a tree (method x
cell x scale) re-scored in one process (port of the JAX package's
eval_all.py).

    python -m srcaco2_tpu_torch.eval_all --exps_root exps
        [--methods SwinIR,DFCAN] [--scales 2,4,8] [--cells CELL0,CELL1]
        [--split test] [--out eval_all_results.json] [--device cpu]

Each directory holding a config_model.yml is an experiment; each goes
through eval.evaluate_pretrained (on the card unless --device cpu). The
results file maps each experiment's path to {'net', 'scale', 'cell',
'status', 'datasets'}: status 'ok' with the summary rows, or 'error:
...' (the sweep goes on). A rerun keeps the 'ok' rows of an existing
results file and re-scores only the others; the file is rewritten
atomically after each experiment.
"""
import argparse
import json
import os
from typing import Iterator

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.eval import evaluate_pretrained
from srcaco2_tpu_torch.utils.logger import DLLogger, fmsg


def find_experiments(exps_root: str) -> Iterator[str]:
    """The directories under exps_root that hold a config_model.yml."""
    for dirpath, _, filenames in os.walk(exps_root):
        if 'config_model.yml' in filenames:
            yield dirpath


def _cell(cfg: dict):
    """The last cell name found in the config's test_dsets (JAX's rule),
    else None."""
    cell = None
    for c in constants.CELLS:
        if c in str(cfg.get('test_dsets', '')):
            cell = c
    return cell


def _dump(results: dict, out: str) -> None:
    tmp = out + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(results, f, indent=2)
    os.replace(tmp, out)


def sweep(exps_root: str, out: str, methods=(), scales=(), cells=(),
          split: str = constants.TESTSET, device=None) -> dict:
    """Re-score every experiment under exps_root that passes the filters
    (empty: all) and is not already 'ok' in `out`; returns the results
    written there. With no card visible and device not 'cpu' it raises
    before any experiment is read."""
    resolve_device(device)
    results = {}
    if os.path.isfile(out):
        with open(out) as f:
            results = {k: v for k, v in json.load(f).items()
                       if isinstance(v, dict) and v.get('status') == 'ok'}
        if results:
            DLLogger.log(f'[eval_all] resuming: {len(results)} ok '
                         f'experiments loaded from {out}')
    n_run = 0
    for exp in sorted(find_experiments(exps_root)):
        cfg = yaml_io.load(os.path.join(exp, 'config_model.yml'))
        nt, sc, cell = cfg['netG']['net_type'], int(cfg['scale']), _cell(cfg)
        if (methods and nt not in methods) or (scales and sc not in scales) \
                or (cells and cell not in cells) or exp in results:
            continue
        DLLogger.log(fmsg(f'[{n_run}] {nt} x{sc} {cell}: {exp}'))
        row = {'net': nt, 'scale': sc, 'cell': cell}
        try:
            summary = evaluate_pretrained(exp, split, device=device)
            results[exp] = {**row, 'status': 'ok', 'datasets': summary or {}}
        except Exception as e:  # noqa: BLE001 -- one failure ends no sweep
            DLLogger.log(f'[eval_all] FAILED {exp}: {e!r}')
            results[exp] = {**row, 'status': f'error: {e}'}
        n_run += 1
        _dump(results, out)
    _dump(results, out)
    DLLogger.log(fmsg(f'sweep done: {n_run} experiments -> {out}'))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(prog='srcaco2_tpu_torch.eval_all')
    p.add_argument('--exps_root', default='exps')
    p.add_argument('--methods', default='')
    p.add_argument('--scales', default='')
    p.add_argument('--cells', default='')
    p.add_argument('--split', default=constants.TESTSET)
    p.add_argument('--out', default='eval_all_results.json')
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    ns = p.parse_args(argv)
    DLLogger.init(outdir=None, is_master=True, verbose=True)
    sweep(ns.exps_root, ns.out,
          methods=[m for m in ns.methods.split(',') if m],
          scales=[int(s) for s in ns.scales.split(',') if s],
          cells=[c for c in ns.cells.split(',') if c], split=ns.split,
          device=ns.device)


if __name__ == '__main__':
    main()
