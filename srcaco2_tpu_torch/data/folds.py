"""Fold-file parsing: the dataset split lists (a copy of
srcaco2_tpu/data/folds.py).

Format (folds.zip at the repo root): per dataset directory
`folds/super-resolution/<ds_name>/{l_h.txt,h_l.txt}`, each line a CSV pair
of relative tif paths `low_rel,high_rel` (l_h.txt) / `high_rel,low_rel`
(h_l.txt).
"""
import os
import zipfile
from typing import Dict, List, Optional, Tuple

FOLDS_SUBDIR = os.path.join('folds', 'super-resolution')


def ensure_folds(splits_root: str, folds_zip: Optional[str] = None) -> str:
    """Extract folds.zip into splits_root if not already there. Returns the
    folds/super-resolution directory."""
    target = os.path.join(splits_root, FOLDS_SUBDIR)
    if os.path.isdir(target):
        return target
    if folds_zip is None:
        for cand in (os.path.join(splits_root, 'folds.zip'),
                     os.path.join(os.path.dirname(os.path.dirname(
                         os.path.dirname(os.path.abspath(__file__)))),
                         'folds.zip')):
            if os.path.isfile(cand):
                folds_zip = cand
                break
    if folds_zip and os.path.isfile(folds_zip):
        with zipfile.ZipFile(folds_zip) as z:
            z.extractall(splits_root)
    return target


def parse_pair_file(path: str) -> List[Tuple[str, str]]:
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            a, b = line.split(',')
            pairs.append((a, b))
    return pairs


def get_pairs(splits_root: str, ds_name: str
              ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """Returns (l_h pairs, h_l pairs) for a dataset name."""
    fd = os.path.join(ensure_folds(splits_root), ds_name)
    l_h = parse_pair_file(os.path.join(fd, 'l_h.txt'))
    h_l = parse_pair_file(os.path.join(fd, 'h_l.txt'))
    if len(l_h) != len(h_l):
        raise ValueError(f'{fd}: {len(l_h)} l_h pairs, {len(h_l)} h_l')
    return l_h, h_l


def sample_ids(pairs: List[Tuple[str, str]]) -> List[str]:
    """Stable per-sample string ids (relative high-res path)."""
    return [h for (_, h) in pairs]


def subset_fraction(pairs: List[Tuple[str, str]], frac: float
                    ) -> List[Tuple[str, str]]:
    """Deterministic head-subset of the train pairs (the train_n
    fraction)."""
    if not 0.0 < frac <= 1.0:
        raise ValueError(f'train fraction {frac}')
    if frac >= 1.0:
        return pairs
    n = max(1, int(len(pairs) * frac))
    return pairs[:n]
