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


# diagnosis_check at a tiny size on the CPU: the x2 study set at 64^2,
# the card's blocked k-NN in blocks of 300 dictionary rows, and
# (tiny_swinir) a 16-wide SwinIR of two 2-block stages as the loader's
# default x8 config
DIAG_TINY = dict(size=64, n_train=2, n_test=2, knn_cpu_queries=64,
                 knn_block_rows=300, crop=8, pth_n_test=2)
TINY_SWINIR = dict(swinir_embed_dim=16, swinir_depths=[2, 2],
                   swinir_num_heads=[2, 2], swinir_window_size=4)


def tiny_swinir(monkeypatch):
    import srcaco2_tpu_torch.config.defaults as D
    get_config = D.get_config

    def small(nt):
        args = get_config(nt)
        args['netG'].update(TINY_SWINIR)
        return args
    monkeypatch.setattr(D, 'get_config', small)


def test_diagnosis_check_on_the_cpu(tmp_path, monkeypatch):
    """diagnosis_check on the CPU (the CPU against itself): every
    gate holds but the kernel launches, since no kernel runs on the CPU;
    the .pth rows equal the port's own eval of the same weights, the
    batch walk evaluates both checkpoints, the trace is written."""
    import torch
    tiny_swinir(monkeypatch)
    cs = _chip_smoke()
    rec, ok = cs.diagnosis_check(torch.device('cpu'), 'cpu', str(tmp_path),
                                 sizes=DIAG_TINY)
    assert not ok
    assert {k for k, v in rec['gates'].items() if not v} == {'k5_launches'}
    assert rec['pth']['launches']['grouped'] == 0
    assert rec['pth']['rows_rel_err'] <= cs.DIAG_TOL['pth_rows']
    assert rec['pth']['batch_ok'] == rec['pth']['discovered'] == 2
    assert rec['knn']['dict_rows'] > 0 and rec['knn']['cpu_queries'] == 64
    assert rec['knn']['card_blocks'] > 1
    assert set(rec['wiener']['rows']) == {'bicubic', '0.001', '0.01', '0.1',
                                          '1.0'}
    assert rec['profiling']['trace_bytes'] > 0
    assert set(rec['steps']) >= {'build_dict', 'knn_restore',
                                 'knn_card_subset_blocks',
                                 'exact_match_crop', 'wiener_study',
                                 'eval_pretrained_pth_traced',
                                 'eval_pth_batch'}


def test_diagnosis_check_refuses_without_a_card(tmp_path, monkeypatch):
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    cs = _chip_smoke()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cs.diagnosis_check(torch.device('cuda'), '', str(tmp_path),
                           sizes=DIAG_TINY)
    monkeypatch.setattr(sys, 'argv', ['chip_smoke.py'])
    assert cs.main() != 0


def test_swinir_reference_state_names():
    """The reference SwinIR's names and layouts of a fused port state:
    every parameter once, dense kernels transposed, the index and mask
    buffers beside them."""
    import torch
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.config.parser import _derive
    from srcaco2_tpu_torch.models.registry import define_g
    cs = _chip_smoke()
    a = get_config('SwinIR')
    a.update(scale=8, n_channels=1, h_size=128)
    a['netG'].update(TINY_SWINIR, swinir_in_chans=1)
    model = define_g(_derive(a), 'cpu')
    st = model.state_dict()
    ref = cs.swinir_reference_state(st)
    assert list(ref)[:4] == ['conv_first.weight', 'conv_first.bias',
                             'patch_embed.norm.weight',
                             'patch_embed.norm.bias']
    b1 = 'layers.1.residual_group.blocks.1.'
    assert torch.equal(ref[b1 + 'attn.qkv.weight'],
                       st['stages.1.blocks.qkv_kernel'][1].t())
    assert ref[b1 + 'attn.relative_position_index'].dtype == torch.long
    assert b1 + 'attn_mask' in ref
    assert torch.equal(ref['upsample.4.weight'], st['upsample.convs.2.weight'])
    assert list(ref)[-2:] == ['conv_last.weight', 'conv_last.bias']
