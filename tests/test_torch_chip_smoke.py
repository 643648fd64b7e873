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


def test_entry_opts_turns_every_option_on():
    """entry_opts' flags parse through the port's command line with every
    option on: EDT*ROI sampling, the three local augs always applied,
    ppiw with l1, the loss terms it names (all 13 but norm_img_grad and
    norm_laplace, which skip nearly every bf16 step of the flagship) and
    both regularizers."""
    from srcaco2_tpu_torch.config.parser import get_args
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.losses.master import build_loss
    cs = _chip_smoke()
    args = get_args(['--net_type', 'SwinIR', '--scale', '8']
                    + cs.ENTRY['entry_opts']['flags'])
    cfg = P.from_args(args)
    assert cfg.sample_tr_patch == 'edt*roi' and cfg.ppiw
    for aug in ('da_blur', 'da_dot_bin_noise', 'da_add_gaus_noise'):
        assert getattr(cfg, aug) and getattr(cfg, f'{aug}_prob') == 1.0
    names = build_loss(args).names
    assert set(cs.ENTRY_OPT_TERMS) | {'l1', 'l2', 'ssim'} == \
        set(names) - {'total'}
    assert set(cs.ENTRY_OPT_TERMS) == {
        t for t, _ in cs.OPTION_TERMS} - {'norm_img_grad', 'norm_laplace'}
    assert args['train']['G_regularizer_orthstep'] == 2
    assert args['train']['G_regularizer_clipstep'] == 3


def test_entry_reconstruct_is_entry_x8_as_a_reconstruct_run():
    """entry_reconstruct's flags are entry_x8's plus --task reconstruct,
    and its floor check's numpy PSNR is ops/metrics' (border crop, the
    cap for identical images)."""
    import numpy as np
    import torch
    from srcaco2_tpu_torch.config.parser import get_args
    from srcaco2_tpu_torch.ops.metrics import mb_psnr
    cs = _chip_smoke()
    rec, x8 = cs.ENTRY['entry_reconstruct'], cs.ENTRY['entry_x8']
    flags = list(rec['flags'])
    i = flags.index('--task')
    assert flags[i + 1] == 'reconstruct'
    assert flags[:i] + flags[i + 2:] == x8['flags'] and rec['tools']
    assert {k: v for k, v in rec.items() if k not in ('flags', 'tools')} \
        == {k: v for k, v in x8.items() if k != 'flags'}
    args = get_args(['--net_type', 'SwinIR', '--scale', '8'] + flags)
    assert args['task'] == 'reconstruct' and args['amp']
    r = np.random.default_rng(0)
    e = r.integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    h = np.clip(e.astype(np.int16) + r.integers(-3, 4, e.shape), 0,
                255).astype(np.uint8)
    h[2] = e[2]
    want = mb_psnr(*(torch.from_numpy(a).permute(0, 3, 1, 2).float()
                     for a in (e, h)), border=8)
    assert abs(cs.numpy_psnr(e, h, 8) - float(want.mean())) <= 1e-4
