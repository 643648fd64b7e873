"""Fold-layout manifest validator — the real-data last mile (port of
srcaco2_tpu/diagnosis/manifest.py, on the port's data/folds.py).

The SR-CACO-2 distribution is consumed through the fold files
(`folds/super-resolution/<ds>/{l_h.txt,h_l.txt}`, reference:
dlib/utils/utils_dataloaders.py:27 get_pairs) plus the tif tree they
reference. Everything downstream (loaders, eval, onboarding parity)
assumes that layout is intact; a silently-truncated download or a
re-rooted extraction fails late and confusingly. This module fails it
EARLY and precisely:

  python -m srcaco2_tpu_torch.diagnosis.manifest --splits_root S \
      [--data_root D] \
      [--expected srcaco2_tpu_torch/diagnosis/folds_manifest.yaml]

- structural checks per dataset: both fold files present, equal pair
  counts, unique keys, h_l.txt is the key/value inverse of l_h.txt
  (the two files encode the same mapping in both directions);
- checksum checks vs an expected manifest (the shipped
  `folds_manifest.yaml` is generated from the repo's folds.zip — the
  reference's own split lists — so any edited/truncated fold file is
  caught byte-exactly);
- image checks when --data_root is given: every referenced relative
  path exists (synthesized-LR `None_*` keys are skipped, same rule as
  the loaders), with the first few missing paths named.

`write_manifest` regenerates the expected-manifest yaml (used once at
build time and by tests). The port writes it as JSON under the same
name (config/yaml_io.to_json), which yaml.safe_load reads as well, so
that it reads back without PyYAML; the shipped copy holds the same
datasets, pair counts and checksums as the JAX package's.
"""
import hashlib
import os
from typing import Dict, List, Optional

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.data.folds import (FOLDS_SUBDIR, ensure_folds,
                                          parse_pair_file)

SHIPPED_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'folds_manifest.yaml')


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def all_dataset_names() -> List[str]:
    """The full 27-dataset grid (3 splits x 3 scales x 3 cells)."""
    return [constants.caco2_name(split, scale, cell)
            for split in constants.SPLITS
            for scale in (2, 4, 8)
            for cell in constants.CELLS]


def fold_manifest(splits_root: str,
                  ds_names: Optional[List[str]] = None) -> Dict:
    """{ds: {l_h.txt: {sha256, pairs}, h_l.txt: {...}}} for every fold
    file found under splits_root."""
    folds_dir = ensure_folds(splits_root)
    out: Dict = {}
    for ds in ds_names or sorted(os.listdir(folds_dir)):
        dd = os.path.join(folds_dir, ds)
        if not os.path.isdir(dd):
            continue
        ent = {}
        for fn in ('l_h.txt', 'h_l.txt'):
            p = os.path.join(dd, fn)
            if os.path.isfile(p):
                ent[fn] = {'sha256': _sha256(p),
                           'pairs': len(parse_pair_file(p))}
        if ent:
            out[ds] = ent
    return out


def write_manifest(splits_root: str,
                   out_path: str = SHIPPED_MANIFEST) -> Dict:
    man = fold_manifest(splits_root)
    with open(out_path, 'w') as f:
        f.write(yaml_io.to_json({'note': 'sha256/pair-count manifest of '
                                         'the shipped fold files '
                                         '(folds.zip)',
                                 'datasets': man}) + '\n')
    return man


def _is_synth_key(rel: str) -> bool:
    """'None_<unique>' keys mean the LR side is synthesized on the fly
    (reference get_pairs docstring) — there is no file to check."""
    return rel.startswith('None')


def validate_dataset(folds_dir: str, ds: str,
                     data_root: Optional[str] = None,
                     expected: Optional[Dict] = None,
                     max_missing_listed: int = 5) -> Dict:
    """Structural + checksum + image-existence checks for one dataset.
    Returns {'ok': bool, 'errors': [...], 'n_pairs': int}."""
    errors: List[str] = []
    dd = os.path.join(folds_dir, ds)
    if not os.path.isdir(dd):
        return {'ok': False, 'errors': [f'missing fold dir {ds}'],
                'n_pairs': 0}
    pairs = {}
    for fn in ('l_h.txt', 'h_l.txt'):
        p = os.path.join(dd, fn)
        if not os.path.isfile(p):
            errors.append(f'{ds}/{fn}: missing')
            continue
        rows = parse_pair_file(p)
        keys = [a for a, _ in rows]
        if len(set(keys)) != len(keys):
            errors.append(f'{ds}/{fn}: duplicate keys')
        pairs[fn] = rows
        if expected and ds in expected and fn in expected[ds]:
            want = expected[ds][fn]
            if want.get('pairs') not in (None, len(rows)):
                errors.append(f'{ds}/{fn}: {len(rows)} pairs, manifest '
                              f'says {want["pairs"]}')
            got = _sha256(p)
            if want.get('sha256') not in (None, got):
                errors.append(f'{ds}/{fn}: sha256 mismatch (edited or '
                              f'truncated fold file)')
    if len(pairs) == 2:
        lh, hl = pairs['l_h.txt'], pairs['h_l.txt']
        if len(lh) != len(hl):
            errors.append(f'{ds}: l_h has {len(lh)} pairs, h_l '
                          f'{len(hl)}')
        elif dict(hl) != {h: l for l, h in lh}:
            errors.append(f'{ds}: h_l.txt is not the inverse mapping '
                          f'of l_h.txt')
    n_pairs = len(pairs.get('l_h.txt', []))
    if data_root is not None and 'l_h.txt' in pairs:
        missing = []
        for low, high in pairs['l_h.txt']:
            for rel in (low, high):
                if not _is_synth_key(rel) and \
                        not os.path.isfile(os.path.join(data_root, rel)):
                    missing.append(rel)
        if missing:
            shown = ', '.join(missing[:max_missing_listed])
            errors.append(f'{ds}: {len(missing)} referenced images '
                          f'missing under {data_root} (first: {shown})')
    return {'ok': not errors, 'errors': errors, 'n_pairs': n_pairs}


def validate_layout(splits_root: str, data_root: Optional[str] = None,
                    expected_path: Optional[str] = None,
                    ds_names: Optional[List[str]] = None) -> Dict:
    """Validate the whole expected grid. Returns
    {'ok': bool, 'datasets': {ds: report}, 'errors': flat list}."""
    expected = None
    if expected_path:
        expected = (yaml_io.load(expected_path) or {}).get('datasets')
    folds_dir = ensure_folds(splits_root)
    reports, flat = {}, []
    for ds in ds_names or all_dataset_names():
        rep = validate_dataset(folds_dir, ds, data_root=data_root,
                               expected=expected)
        reports[ds] = rep
        flat += rep['errors']
    return {'ok': not flat, 'datasets': reports, 'errors': flat}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description='validate an SR-CACO-2 fold layout before first '
                    'use (structure, checksums, image existence)')
    ap.add_argument('--splits_root', required=True,
                    help=f'directory holding {FOLDS_SUBDIR} (folds.zip '
                         'is auto-extracted here if absent)')
    ap.add_argument('--data_root', default=None,
                    help='image tree root; when given, every '
                         'referenced tif must exist')
    ap.add_argument('--expected', default=None,
                    help='expected-manifest yaml (default: the '
                         'shipped folds_manifest.yaml when present; '
                         'pass "none" to skip checksum checks)')
    ap.add_argument('--datasets', default=None,
                    help='comma list (default: the full 27-ds grid)')
    ns = ap.parse_args(argv)
    expected = ns.expected
    if expected is None and os.path.isfile(SHIPPED_MANIFEST):
        expected = SHIPPED_MANIFEST
    if expected == 'none':
        expected = None
    ds_names = ns.datasets.split(',') if ns.datasets else None
    rep = validate_layout(ns.splits_root, data_root=ns.data_root,
                          expected_path=expected, ds_names=ds_names)
    n_ok = sum(r['ok'] for r in rep['datasets'].values())
    for ds, r in rep['datasets'].items():
        status = 'ok' if r['ok'] else 'FAIL'
        print(f'{ds}: {r["n_pairs"]} pairs {status}')
        for e in r['errors']:
            print(f'  !! {e}')
    print(f'# {n_ok}/{len(rep["datasets"])} datasets ok'
          + ('' if rep['ok'] else f' — {len(rep["errors"])} errors'))
    return 0 if rep['ok'] else 1


if __name__ == '__main__':
    import sys
    sys.exit(main())
