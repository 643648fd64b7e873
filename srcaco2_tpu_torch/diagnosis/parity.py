"""Parity harness and the real-data onboarding kit (port of
srcaco2_tpu/diagnosis/parity.py): compare the port's metrics against the
published SR-CACO-2 numbers (BASELINE.md, NeurIPS-2024 Tables 4/5), and
load and evaluate the reference's pretrained `.pth` checkpoints.

The bicubic rows are model-free, so they are a cross-check of the whole
eval stack (LR handling, resize, uint8 rounding, border crop, ROI
marginalization) once the real dataset is present:

    from srcaco2_tpu_torch.diagnosis.parity import check_bicubic_parity
    check_bicubic_parity(data_root, splits_root, scale=8)

One command (reference: eval.py:46, select_network.py:19, README
pretrained section) verifies the bicubic Table-5/4 rows on the real
data, optionally ports and evaluates a reference pretrained `.pth` (or
every one under a shared-trained-models tree), and writes a
Table-5-format markdown:

    python -m srcaco2_tpu_torch.diagnosis.parity --data_root D \\
        [--scales 2,4,8] [--cells CELL0,CELL1,CELL2] \\
        [--pth best-models/G-model.pth --net SwinIR --pth_scale 8 \\
         --pth_cell CELL2] [--pth_root TREE] [--out report.md] \\
        [--device cpu]

Everything runs on the card unless --device cpu (device='cpu') is given;
without a visible card it raises, as the port's main and eval do. A
ported `.pth` runs through the port's net and eval forward: SwinIR in
the fused layout evaluates through the grouped block kernel (K5).
"""
import os
from typing import Dict

import numpy as np
import torch

from srcaco2_tpu_torch import constants, exact_f32, resolve_device

# Published full-image bicubic PSNR (dB) per (scale, cell) — Table 5.
PUBLISHED_BICUBIC_FULL_PSNR = {
    (2, 'CELL0'): 41.29, (2, 'CELL1'): 38.23, (2, 'CELL2'): 36.34,
    (4, 'CELL0'): 41.76, (4, 'CELL1'): 38.22, (4, 'CELL2'): 37.07,
    (8, 'CELL0'): 37.82, (8, 'CELL1'): 32.78, (8, 'CELL2'): 31.01,
}
# ROI-marginalized bicubic PSNR — Table 4.
PUBLISHED_BICUBIC_ROI_PSNR = {
    (2, 'CELL0'): 35.02, (2, 'CELL1'): 32.15, (2, 'CELL2'): 30.38,
    (4, 'CELL0'): 35.46, (4, 'CELL1'): 32.03, (4, 'CELL2'): 31.10,
    (8, 'CELL0'): 31.88, (8, 'CELL1'): 27.50, (8, 'CELL2'): 26.10,
}
# Flagship parity anchors (BASELINE.md).
PUBLISHED_SWINIR_X8_CELL2 = {'full_psnr': 30.60, 'roi_psnr': 26.48}


def eval_args(data_root: str, splits_root: str, scale: int,
              device=None) -> Dict:
    """The eval config of a one-channel test split on `device` (default
    the card): the studies' and the bicubic check's."""
    return {'data_root': data_root, 'splits_root': splits_root,
            'scale': scale, 'n_channels': 1, 'myseed': 0,
            'use_interpolated_low': False, 'inter_low_th': 7.,
            'inter_low_sigma': 6., 'num_workers': 8,
            'eval_over_roi_also': True,
            'eval_over_roi_also_ths': constants.ROI_THRESH,
            'is_master': True, 'device': str(resolve_device(device))}


def eval_bicubic(data_root: str, splits_root: str, scale: int,
                 cell: str, n: int = -1, device=None) -> Dict:
    """Run the bicubic Interpolate baseline on the real test split."""
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.train.evaluator import (fast_eval,
                                                   make_interpolate_forward)
    args = eval_args(data_root, splits_root, scale, device)
    name = constants.caco2_name(constants.TESTSET, scale, cell)
    ds = load_dataset(args, name, constants.EVAL_PHASE, n=n)
    fwd = make_interpolate_forward(scale, constants.INTER_BICUBIC)
    return fast_eval(fwd, None, ds, args, 8, constants.TESTSET)


def check_bicubic_parity(data_root: str, splits_root: str, scale: int,
                         tol_db: float = 0.05, n: int = -1,
                         cells=None, published_full=None,
                         published_roi=None, device=None) -> Dict:
    """Evaluate bicubic on the cells of a scale; return per-cell
    metrics + deltas vs the published tables (|delta| <= tol_db
    passes). published_full/_roi override the shipped constants
    ({(scale, cell): psnr}) — used by the synthetic pre-test."""
    published_full = published_full or PUBLISHED_BICUBIC_FULL_PSNR
    published_roi = published_roi or PUBLISHED_BICUBIC_ROI_PSNR
    out = {}
    for cell in (cells or constants.CELLS):
        perf = eval_bicubic(data_root, splits_root, scale, cell, n, device)
        got_full = perf['full'][constants.PSNR_MTR]
        got_roi = perf['roi'][constants.PSNR_MTR]
        want_full = published_full.get((scale, cell))
        want_roi = published_roi.get((scale, cell))
        out[cell] = {
            'full': {k: float(v) for k, v in perf['full'].items()},
            'roi': {k: float(v) for k, v in perf['roi'].items()},
            'n': int(perf['n']),
            'full_psnr': got_full, 'full_published': want_full,
            'roi_psnr': got_roi, 'roi_published': want_roi,
        }
        if want_full is not None and want_roi is not None:
            out[cell].update({
                'full_delta': got_full - want_full,
                'roi_delta': got_roi - want_roi,
                'pass': (abs(got_full - want_full) <= tol_db
                         and abs(got_roi - want_roi) <= tol_db)})
    return out


# ------------------------------------------------- pretrained .pth port
def load_pth_state(path: str):
    """Load a reference checkpoint (torch state_dict, possibly nested
    under the KAIR 'params' key — model_base.py:load_network) into an
    ordered [(name, np.ndarray)] list of FLOAT parameters; integer
    buffers the port rebuilds at run time (e.g. SwinIR
    relative_position_index, attn_mask) are dropped."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'params' in sd \
            and isinstance(sd['params'], dict):
        sd = sd['params']
    out = []
    for k, v in sd.items():
        a = v.detach().cpu().numpy() if hasattr(v, 'detach') \
            else np.asarray(v)
        if not np.issubdtype(a.dtype, np.floating):
            continue                      # index/mask buffers
        if k.endswith('relative_position_index') or \
                k.endswith('attn_mask'):
            continue
        out.append((k, a.astype(np.float32)))
    return out


def pth_eval_args(net_type: str, scale: int, data_root: str,
                  splits_root: str, device) -> Dict:
    """The config eval_pretrained_pth builds the net from: the net's
    defaults at one channel, DBPN's and MemNet's remat lifts off (the
    order-based ports need creation-ordered trees)."""
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.config.parser import _derive
    args = get_config(net_type)
    args['scale'] = scale
    args['n_channels'] = 1
    # h_size only seeds the config (eval runs full images); default to
    # 128 for scales outside the published 2/4/8 set
    args['h_size'] = {2: 96, 4: 96, 8: 128}.get(scale, 128)
    args['netG'][f'{net_type.lower()}_in_chans'] = 1
    if net_type == constants.DBPN:
        args['netG']['dbpn_remat_blocks'] = False
    if net_type == constants.MEMNET:
        args['netG']['memnet_remat_passes'] = False
    args.update(eval_args(data_root, splits_root, scale, device))
    return _derive(args)


def port_pth(tp, model: torch.nn.Module, net_type: str, netG: Dict,
             scale: int) -> Dict[str, torch.Tensor]:
    """The port's state (params, and the model's own buffers) of a
    reference state list `tp` (load_pth_state): the flax-layout template
    of `model`, the porter JAX dispatches for the net, then
    bridge.flax_to_torch. The porter dispatch mirrors the JAX package's:
    SwinIR uses the name-based fused-layout port; DBPN and MemNet run
    with their remat lifts off; DSR-Splines uses the stacked port; GRL
    goes through the generic order-based port as in JAX."""
    from srcaco2_tpu_torch.bridge import flax_to_torch
    from srcaco2_tpu_torch.diagnosis import torch_port as TP
    in_hw = 512 if net_type in constants.PRE_UPSAMPLED_INPUT_NETS \
        else 512 // scale
    dev = next(model.parameters()).device
    x0 = torch.zeros((1, 1, in_hw, in_hw), device=dev)
    template = TP.flax_template(model, net_type, x0)
    if net_type == constants.SWINIR and \
            netG.get('swinir_use_fused_blocks', True):
        params = TP.port_swinir(tp, template)
    elif net_type == constants.DSRSPLINES:
        params = TP.port_dsr_splines(tp, template)
    elif net_type == constants.DBPN:
        params = TP.port_dbpn(tp, template, remat_blocks=False)
    else:
        params = TP.port_state_dict(tp, template)
    state = dict(model.state_dict())
    state.update(flax_to_torch(params, model))
    return state


def eval_pretrained_pth(pth: str, net_type: str, scale: int, cell: str,
                        data_root: str, splits_root: str,
                        n: int = -1, device=None) -> Dict:
    """Port a reference pretrained `.pth` into the port's net (port_pth)
    and evaluate it on the real test split through the standard eval
    stack (train/evaluator.fast_eval), on `device` (default the card).
    Returns fast_eval's perf dict."""
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.evaluator import fast_eval
    from srcaco2_tpu_torch.train.steps import make_eval_forward

    args = pth_eval_args(net_type, scale, data_root, splits_root, device)
    dev = torch.device(args['device'])
    exact_f32(dev)
    model = define_g(args, dev)
    tp = load_pth_state(pth)
    model.load_state_dict(port_pth(tp, model, net_type, args['netG'],
                                   scale))
    name = constants.caco2_name(constants.TESTSET, scale, cell)
    ds = load_dataset(args, name, constants.EVAL_PHASE, n=n)
    fwd = make_eval_forward(model, net_type, scale, netG=args['netG'])
    return fast_eval(fwd, None, ds, args, 8, constants.TESTSET)


def discover_pth_checkpoints(pth_root: str):
    """Walk a shared-trained-models tree for reference checkpoints.

    The published layout (reference README "Pretrained weights":
    shared-trained-models.tar.gz, 144 = 16 methods x 3 cells x 3
    scales) nests each checkpoint as
    `.../super-resolution/<NET>/caco2_train_X_<s>_in_*_cell_<CELL>/
    <exp-id with netG_<NET>>/best-models/G-model.pth`.
    Returns [(pth_path, net_type, scale, cell)] sorted by path;
    net/scale/cell are parsed from the path segments (netG_ tag first,
    method-directory fallback), unparseable hits are skipped loudly.
    """
    import glob
    import re
    by_name = {m.lower(): m for m in constants.MODELS}
    out, skipped = [], []
    hits = sorted(glob.glob(os.path.join(
        pth_root, '**', 'best-models', 'G-model.pth'), recursive=True))
    for pth in hits:
        parts = os.path.normpath(pth).split(os.sep)
        scale = cell = net = None
        for seg in parts:
            m = re.match(r'caco2_train_X_(\d+)_in_\d+_out_\d+_cell_'
                         r'(CELL\d)$', seg)
            if m:
                scale, cell = int(m.group(1)), m.group(2)
            m = re.search(r'netG_([A-Za-z0-9_]+?)-', seg)
            if m and m.group(1).lower() in by_name:
                net = by_name[m.group(1).lower()]
        if net is None:     # method-directory fallback (…/<NET>/<ds>/…)
            for seg in parts:
                if seg.replace('-', '').lower() in by_name:
                    net = by_name[seg.replace('-', '').lower()]
        if net and scale and cell:
            out.append((pth, net, scale, cell))
        else:
            skipped.append(pth)
    for p in skipped:
        print(f'!! unparseable checkpoint path skipped: {p}',
              flush=True)
    return out


def eval_pth_batch(pth_root: str, data_root: str, splits_root: str,
                   results: Dict, n: int = -1, device=None) -> Dict:
    """Port + evaluate every discovered checkpoint. As in the JAX
    package, a checkpoint whose port or evaluation fails is recorded and
    printed, and the walk goes on to the next one (the caller's exit
    code reports the failures). Mutates `results`
    ({scale: {'bicubic', 'methods'}}) in place and returns
    {'n_ok': int, 'failures': {label: error}}."""
    found = discover_pth_checkpoints(pth_root)
    print(f'# --pth_root: {len(found)} checkpoints discovered',
          flush=True)
    failures = {}
    n_ok = 0
    for pth, net, scale, cell in found:
        label = f'{net} (ported .pth)'
        try:
            perf = eval_pretrained_pth(pth, net, scale, cell, data_root,
                                       splits_root, n=n, device=device)
        except Exception as e:  # noqa: BLE001 — recorded, reported
            failures[f'{net} x{scale} {cell}'] = \
                f'{type(e).__name__}: {e}'
            print(f'x{scale} {cell}: {label} FAILED '
                  f'({type(e).__name__}: {e})', flush=True)
            continue
        results.setdefault(scale, {'bicubic': {}, 'methods': {}})
        results[scale]['methods'].setdefault(label, {})[cell] = {
            'full': {k: float(x) for k, x in perf['full'].items()},
            'roi': {k: float(x) for k, x in perf['roi'].items()}}
        n_ok += 1
        print(f"x{scale} {cell}: {label} full "
              f"{perf['full']['psnr']:.2f} dB, roi "
              f"{perf['roi']['psnr']:.2f}", flush=True)
    return {'n_ok': n_ok, 'failures': failures}


# ---------------------------------------------------- markdown report
def _fmt_row(name, per_cell, cells):
    """One Table-5-format markdown row: PSNR / NRMSE / SSIM per cell
    plus the 3-cell means; missing nrmse renders as nan rather than
    raising."""
    nan = float('nan')
    vals = []
    for c in cells:
        m = per_cell.get(c)
        vals.append('—' if m is None else
                    f"{m['psnr']:.2f} / {m.get('nrmse', nan):.4f} / "
                    f"{m['ssim']:.4f}")
    have = [per_cell[c] for c in cells if per_cell.get(c)]
    mean = (f"{np.mean([m['psnr'] for m in have]):.2f} / "
            f"{np.mean([m.get('nrmse', nan) for m in have]):.4f} / "
            f"{np.mean([m['ssim'] for m in have]):.4f}") if have else '—'
    return f"| {name} | " + ' | '.join(vals) + f" | {mean} |"


def build_report(results: Dict, cells, out_path: str) -> str:
    """results: {scale: {'bicubic': {cell: check-dict},
    'methods': {label: {cell: perf}}}} -> Table-5-format markdown."""
    lines = ['# SR-CACO-2 onboarding report',
             '',
             'Test-split metrics through the published protocol '
             '(uint8-rounded [0,255], border=scale crop, ROI '
             'marginalized over thresholds 4..10). Cells report '
             'PSNR dB / NRMSE / SSIM.', '']
    for scale in sorted(results):
        r = results[scale]
        lines += [f'## X{scale}', '',
                  '| method | ' + ' | '.join(cells) + ' | mean |',
                  '|---|' + '---|' * (len(cells) + 1)]
        bic = r.get('bicubic', {})
        lines.append(_fmt_row(
            'Bicubic', {c: bic[c]['full'] for c in bic}, cells))
        for label, per_cell in r.get('methods', {}).items():
            lines.append(_fmt_row(
                label, {c: p['full'] for c, p in per_cell.items()},
                cells))
        # published-delta verification lines
        checks = []
        for c in cells:
            if c in bic and 'pass' in bic[c]:
                checks.append(
                    f"{c}: got {bic[c]['full_psnr']:.2f} vs published "
                    f"{bic[c]['full_published']:.2f} "
                    f"(Δ{bic[c]['full_delta']:+.3f} dB), ROI "
                    f"{bic[c]['roi_psnr']:.2f} vs "
                    f"{bic[c]['roi_published']:.2f} "
                    f"(Δ{bic[c]['roi_delta']:+.3f}) — "
                    f"{'PASS' if bic[c]['pass'] else 'FAIL'}")
        if checks:
            lines += ['', '**Bicubic vs published (eval-stack '
                      'verification):**', '']
            lines += [f'- {c}' for c in checks]
        lines.append('')
    md = '\n'.join(lines)
    if out_path:
        with open(out_path, 'w') as f:
            f.write(md)
    return md


def main(argv=None):
    import argparse
    from srcaco2_tpu_torch.config import yaml_io
    ap = argparse.ArgumentParser(
        prog='srcaco2_tpu_torch.diagnosis.parity',
        description='SR-CACO-2 real-data onboarding kit')
    ap.add_argument('--data_root', required=True)
    ap.add_argument('--splits_root', default=None,
                    help='defaults to --data_root')
    ap.add_argument('--scales', default='2,4,8')
    ap.add_argument('--cells', default=','.join(constants.CELLS))
    ap.add_argument('--n', type=int, default=-1,
                    help='test images per dataset (-1 = all)')
    ap.add_argument('--tol', type=float, default=0.05,
                    help='published-delta tolerance (dB)')
    ap.add_argument('--pth', default=None,
                    help='reference pretrained state_dict to port + '
                         'evaluate (best-models/G-model.pth)')
    ap.add_argument('--pth_root', default=None,
                    help='shared-trained-models tree: discover + port '
                         '+ evaluate EVERY .../best-models/G-model.pth '
                         'under it in one invocation (net/scale/cell '
                         'parsed from the published path layout)')
    ap.add_argument('--net', default=constants.SWINIR,
                    help='net_type of --pth')
    ap.add_argument('--pth_scale', type=int, default=8,
                    choices=[2, 4, 8])
    ap.add_argument('--pth_cell', default='CELL2')
    ap.add_argument('--published', default=None,
                    help="yaml overriding the published bicubic "
                         "tables: {full: {'<scale>,<cell>': psnr}, "
                         "roi: {...}} — the synthetic pre-test path")
    ap.add_argument('--out', default='onboarding_report.md')
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ns = ap.parse_args(argv)
    resolve_device(ns.device)

    splits = ns.splits_root or ns.data_root
    cells = [c for c in ns.cells.split(',') if c]
    pub_full = pub_roi = None
    if ns.published:
        pub = yaml_io.load(ns.published)

        def parse(d):
            return {(int(k.split(',')[0].strip()),
                     k.split(',')[1].strip()): float(v)
                    for k, v in (d or {}).items()}
        pub_full, pub_roi = parse(pub.get('full')), parse(pub.get('roi'))

    results = {}
    all_pass = True
    n_checked = 0
    for scale in [int(s) for s in ns.scales.split(',') if s]:
        chk = check_bicubic_parity(
            ns.data_root, splits, scale, tol_db=ns.tol, n=ns.n,
            cells=cells, published_full=pub_full, published_roi=pub_roi,
            device=ns.device)
        results[scale] = {'bicubic': chk, 'methods': {}}
        for c, v in chk.items():
            if 'pass' in v:
                status = 'PASS' if v['pass'] else 'FAIL'
                all_pass &= v['pass']
                n_checked += 1
            else:
                # loud, not silent: metrics computed but nothing to
                # verify against — a malformed --published key lands
                # here, and so would a typo'd cell name
                status = 'NO-PUBLISHED-ROW (verification skipped)'
            print(f"x{scale} {c}: bicubic full "
                  f"{v['full_psnr']:.2f} dB, roi {v['roi_psnr']:.2f} "
                  f"{status}", flush=True)

    if ns.pth:
        perf = eval_pretrained_pth(ns.pth, ns.net, ns.pth_scale,
                                   ns.pth_cell, ns.data_root, splits,
                                   n=ns.n, device=ns.device)
        label = f'{ns.net} (ported .pth)'
        results.setdefault(ns.pth_scale, {'bicubic': {}, 'methods': {}})
        results[ns.pth_scale]['methods'][label] = {
            ns.pth_cell: {'full': {k: float(x) for k, x
                                   in perf['full'].items()},
                          'roi': {k: float(x) for k, x
                                  in perf['roi'].items()}}}
        print(f"x{ns.pth_scale} {ns.pth_cell}: {label} full "
              f"{perf['full']['psnr']:.2f} dB, roi "
              f"{perf['roi']['psnr']:.2f}", flush=True)

    batch = None
    if ns.pth_root:
        batch = eval_pth_batch(ns.pth_root, ns.data_root, splits,
                               results, n=ns.n, device=ns.device)

    build_report(results, cells, ns.out)
    print(f'# wrote {ns.out}')
    if batch:
        print(f"# batch: {batch['n_ok']} checkpoints evaluated, "
              f"{len(batch['failures'])} failed", flush=True)
        for k, v in batch['failures'].items():
            print(f'#   FAILED {k}: {v}', flush=True)
        if batch['failures']:
            return 3
    if n_checked == 0:
        print('WARNING: no (scale, cell) matched a published row — '
              'the eval-stack verification never ran. Check the '
              '--published yaml keys ("<scale>,<cell>") and --cells.',
              flush=True)
        return 2
    return 0 if all_pass else 1


if __name__ == '__main__':
    import sys
    sys.exit(main())
