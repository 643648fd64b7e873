"""Metric tracker (port of srcaco2_tpu/utils/tracker.py): a nested dict
of train losses and eval metrics with best-value tracking, persisted to
pickle in the JAX package's layout, plotted with matplotlib.

matplotlib is imported lazily: where it cannot be imported (the card
machine), `plot_tracker` and `plot_tracker_dashboard` log one line and
draw nothing; the pickle still holds every number.
"""
import os
import pickle
from typing import Dict, List, Optional

from srcaco2_tpu_torch import constants

PERIOD_EPOCH = 'period_epoch'
PERIOD_ITER = 'period_iter'


def init_tracker(loss_names: List[str], eval_ds_names: List[str],
                 metrics: Optional[List[str]] = None) -> dict:
    metrics = metrics or constants.METRICS
    t: Dict = {'train': {PERIOD_EPOCH: {}, PERIOD_ITER: {}}}
    for period in (PERIOD_EPOCH, PERIOD_ITER):
        for name in loss_names:
            t['train'][period][name] = []
    for split in (constants.VALIDSET, constants.TESTSET):
        t[split] = {}
        for ds in eval_ds_names:
            t[split][ds] = {}
            for m in metrics:
                t[split][ds][m] = {'vals': [], 'steps': [],
                                   'best_val': None, 'idx_best': -1}
    return t


def update_tracker_train(tracker: dict, period: str,
                         losses: Dict[str, float]):
    assert period in (PERIOD_EPOCH, PERIOD_ITER), period
    holder = tracker['train'][period]
    for name, val in losses.items():
        holder.setdefault(name, []).append(float(val))


def update_tracker_eval(tracker: dict, split: str, ds: str,
                        metrics: Dict[str, float], step: int,
                        master_metric: str) -> bool:
    """Append one eval point. The master metric decides whether this point
    is the new best; every other metric's `idx_best` follows the master's
    index. Returns True if new best."""
    holder = tracker[split][ds]
    is_best = False
    cmp = constants.BEST_MTR[master_metric]
    m_rec = holder[master_metric]
    new_val = float(metrics[master_metric])
    if m_rec['best_val'] is None or \
            cmp(new_val, m_rec['best_val']) == new_val:
        is_best = True
    new_idx = len(m_rec['vals'])
    for m, v in metrics.items():
        if m not in holder:
            holder[m] = {'vals': [], 'steps': [], 'best_val': None,
                         'idx_best': -1}
        rec = holder[m]
        rec['vals'].append(float(v))
        rec['steps'].append(int(step))
        if is_best:
            rec['idx_best'] = new_idx
            rec['best_val'] = rec['vals'][new_idx]
    return is_best


def best_of(tracker: dict, split: str, ds: str, metric: str):
    rec = tracker[split][ds][metric]
    return rec['best_val'], rec['idx_best']


def save_tracker(tracker: dict, outdir: str, name: str = 'tracker.pkl'):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, name), 'wb') as f:
        pickle.dump(tracker, f, protocol=pickle.HIGHEST_PROTOCOL)


def find_last_tracker(outdir: str, name: str = 'tracker.pkl'
                      ) -> Optional[dict]:
    path = os.path.join(outdir, name)
    if os.path.isfile(path):
        with open(path, 'rb') as f:
            return pickle.load(f)
    return None


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (logged) where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        from srcaco2_tpu_torch.utils.logger import DLLogger
        DLLogger.log('[plot] matplotlib is not installed: no figures '
                     '(the tracker pickle holds the numbers)')
        return None
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def plot_tracker(tracker: dict, outdir: str, prefix: str = 'tracker'):
    """Matplotlib dashboards: one figure for train losses, one per eval
    split with a subplot per (dataset, metric)."""
    plt = _pyplot()
    if plt is None:
        return

    os.makedirs(outdir, exist_ok=True)
    # train losses
    for period in (PERIOD_EPOCH, PERIOD_ITER):
        holder = tracker['train'][period]
        names = [n for n, v in holder.items() if v]
        if not names:
            continue
        fig, axes = plt.subplots(len(names), 1,
                                 figsize=(8, 2.5 * len(names)),
                                 squeeze=False)
        for ax, n in zip(axes[:, 0], names):
            ax.plot(holder[n])
            ax.set_title(f'train/{n} [{period}]', fontsize=9)
            ax.grid(True, alpha=.3)
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, f'{prefix}_train_{period}.png'),
                    dpi=100)
        plt.close(fig)
    # eval metrics
    for split in (constants.VALIDSET, constants.TESTSET):
        if split not in tracker:
            continue
        for ds, mdict in tracker[split].items():
            names = [m for m, rec in mdict.items() if rec['vals']]
            if not names:
                continue
            fig, axes = plt.subplots(len(names), 1,
                                     figsize=(8, 2.5 * len(names)),
                                     squeeze=False)
            for ax, m in zip(axes[:, 0], names):
                rec = mdict[m]
                ax.plot(rec['steps'], rec['vals'], marker='.')
                if rec['idx_best'] >= 0:
                    ax.axvline(rec['steps'][rec['idx_best']],
                               color='r', ls='--', alpha=.5)
                ax.set_title(f'{split}/{ds}/{m} '
                             f'(best={rec["best_val"]})', fontsize=8)
                ax.grid(True, alpha=.3)
            fig.tight_layout()
            safe_ds = ds.replace('/', '_')
            fig.savefig(
                os.path.join(outdir, f'{prefix}_{split}_{safe_ds}.png'),
                dpi=100)
            plt.close(fig)


def plot_tracker_dashboard(tracker: dict, roi_tracker: dict,
                           split: str, out_path: str,
                           roi_select: bool = False):
    """One eval dashboard: rows = datasets, cols = metrics; the
    full-image and ROI curves overlaid (the model-selection curve solid,
    the other dashed/faded), best iteration marked per panel."""
    if split not in tracker or not tracker[split]:
        return None
    plt = _pyplot()
    if plt is None:
        return None
    dsets = list(tracker[split].keys())
    metrics = list(tracker[split][dsets[0]].keys())
    if not dsets or not metrics:
        return None
    fig, axes = plt.subplots(len(dsets), len(metrics),
                             figsize=(2.8 * len(metrics),
                                      2.2 * len(dsets)),
                             squeeze=False)
    a_full, a_roi = (0.4, 1.0) if roi_select else (1.0, 0.4)
    ls_full, ls_roi = ('dashed', 'solid') if roi_select \
        else ('solid', 'dashed')
    for i, ds in enumerate(dsets):
        for j, m in enumerate(metrics):
            ax = axes[i, j]
            rec = tracker[split][ds].get(m)
            if rec and rec['vals']:
                ax.plot(rec['steps'], rec['vals'], color='C0',
                        alpha=a_full, ls=ls_full, label='full')
                if rec['idx_best'] >= 0:
                    ax.plot(rec['steps'][rec['idx_best']],
                            rec['vals'][rec['idx_best']], 'r*', ms=8)
            rrec = (roi_tracker or {}).get(split, {}).get(ds, {}) \
                .get(m)
            if rrec and rrec['vals']:
                ax.plot(rrec['steps'], rrec['vals'], color='C1',
                        alpha=a_roi, ls=ls_roi, label='roi')
            if i == 0:
                ax.set_title(m, fontsize=8)
            if j == 0:
                ax.set_ylabel(ds[:28], fontsize=6)
            ax.grid(alpha=.3)
            ax.tick_params(labelsize=6)
    axes[0, 0].legend(fontsize=6)
    fig.suptitle(f'{split} dashboard', fontsize=10)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
