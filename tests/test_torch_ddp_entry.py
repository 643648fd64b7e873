"""`python -m srcaco2_tpu_torch.main --distributed True --device cpu` on
two gloo ranks (tests/torch_ddp_worker.py: each rank runs main in a
spawned process, as torchrun would start it, its process group on a
file:// store) against the one-process run on the same synthetic
dataset: both ranks exit 0 and only rank 0 writes in the experiment
tree (sys audit hooks); the final params within 1e-5 relative L2; the
validation and test metrics within 1e-6, relative for PSNR (~14 dB
moves by 2.5e-6 dB: the params differ in their last bits, the
uint8-rounded predictions in a few pixels) and absolute for SSIM and
NRMSE (< 1); `eval` re-scores the 2-rank
experiment in one plain process and under 2 ranks to the same numbers;
the gathered fast_eval equals the one-process one exactly; the
superstep probe leaves training bit for bit as it was; a rank whose
evaluation fails ends both ranks, non-zero, at once."""
import glob
import os
import pickle

import numpy as np
import pytest
import torch

from srcaco2_tpu.train.trainer import choose_superstep as j_choose
from srcaco2_tpu_torch import main as TMAIN
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.eval import evaluate_pretrained
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train.trainer import choose_superstep
from srcaco2_tpu_torch.utils.logger import DLLogger

from test_torch_ddp_step import rel_l2
from test_torch_entry_train import TINY_FLAGS
from torch_ddp_worker import (PG_TIMEOUT_S, eval_rank, fast_eval_rank,
                              main_rank, spawn)


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    DLLogger.reset()


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=8,
                                   n_val=3, n_test=3, size=64)
    return root, names


def _argv(root, names, swinir=True, **extra):
    argv = ['--device', 'cpu', '--scale', '2', '--h_size', '16',
            '--n_channels', '1', '--train_dsets', names[0],
            '--valid_dsets', names[1], '--test_dsets', names[2],
            '--data_root', root, '--splits_root', root, '--l2', 'True',
            '--ssim', 'True', '--ssim_lambda', '5.', '--ssim_window_s', '7',
            '--eval_over_roi_also', 'True', '--batch_size', '4',
            '--eval_bsize', '1', '--max_epochs', '2',
            '--checkpoint_eval', '1.0', '--checkpoint_save', '1.0',
            '--E_decay', '0.9', '--eval_netE', 'True',
            '--plot_epoch_freq', '0', '--verbose', 'False']
    argv += TINY_FLAGS if swinir else ['--net_type', 'SRCNN']
    for k, v in extra.items():
        argv += [f'--{k}', str(v)]
    return argv


def _exp(cwd):
    done = glob.glob(os.path.join(cwd, 'exps', '**', 'passed.txt'),
                     recursive=True)
    assert len(done) == 1, done
    return os.path.dirname(done[0])


def _tracker(exp, sub=''):
    with open(os.path.join(exp, sub, 'tracker.pkl'), 'rb') as f:
        return pickle.load(f)


def _rows(tracker, split):
    return {ds: {m: np.asarray(v['vals']) for m, v in mets.items()}
            for ds, mets in tracker[split].items()}


def _final_params(exp):
    step = CKPT.find_last_checkpoint(exp)
    return torch.load(os.path.join(exp, 'models', f'{step}_G.pt'),
                      weights_only=True), step


@pytest.fixture(scope='module')
def runs(synth, tmp_path_factory):
    """The one-process run (in this process) and the 2-rank run."""
    root, names = synth
    one = tmp_path_factory.mktemp('one')
    cwd = os.getcwd()
    try:
        os.chdir(one)
        TMAIN.main(_argv(root, names))
    finally:
        os.chdir(cwd)
        DLLogger.reset()
    two = tmp_path_factory.mktemp('two')
    work = tmp_path_factory.mktemp('work')
    audit = str(work / 'audit_')
    codes, _, seconds = spawn(main_rank, 2, work,
                              dict(cwd=str(two), argv=_argv(root, names),
                                   audit=audit))
    return dict(one=_exp(str(one)), two=_exp(str(two)), codes=codes,
                audit=audit, seconds=seconds)


def test_two_ranks_train_and_only_rank_0_writes(runs):
    assert runs['codes'] == [0, 0]
    with open(runs['audit'] + '0.txt') as f:
        written = f.read().split('\n')
    with open(runs['audit'] + '1.txt') as f:
        assert f.read() == ''
    two = runs['two']
    for name in ('config.yml', 'passed.txt', 'tracker.pkl',
                 'run_stats.json', 'best-models/G-model.pt'):
        assert any(w.endswith(os.path.join(two, name)) for w in written), \
            name
    with open(os.path.join(two, 'run_stats.json')) as f:
        assert '"world_size": 2' in f.read()


def test_two_ranks_match_one_process(runs):
    (p1, s1), (p2, s2) = _final_params(runs['one']), \
        _final_params(runs['two'])
    assert s1 == s2 == 4
    assert rel_l2(p2, p1) <= 1e-5
    t1, t2 = _tracker(runs['one']), _tracker(runs['two'])
    for split in ('val', 'test'):
        r1, r2 = _rows(t1, split), _rows(t2, split)
        assert r1.keys() == r2.keys()
        for ds in r1:
            for m in ('psnr', 'ssim', 'nrmse'):
                np.testing.assert_allclose(r2[ds][m], r1[ds][m],
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=(split, ds, m))
    np.testing.assert_allclose(
        t2['train']['period_iter']['total'],
        t1['train']['period_iter']['total'], rtol=1e-5)


def test_eval_rescores_in_one_process_and_under_two_ranks(runs, tmp_path):
    """`eval` of the 2-rank experiment in one plain process (no
    launcher) equals its final test within 1e-6; `eval --distributed
    True` on 2 ranks equals the one-process `eval` exactly, per image
    too (best-models/details_test_*.yml, written by rank 0)."""
    two = runs['two']
    test = _rows(_tracker(two), 'test')
    one = evaluate_pretrained(two, device='cpu')
    DLLogger.reset()
    details = sorted(glob.glob(os.path.join(two, 'best-models',
                                            'details_test_*.yml')))
    assert details
    before = [open(f).read() for f in details]
    for ds, row in one.items():
        for m in ('psnr', 'ssim'):
            assert abs(row[m] - test[ds][m][-1]) <= 1e-6, (ds, m)
    codes, (s0, s1), _ = spawn(eval_rank, 2, tmp_path, dict(exp=two))
    assert codes == [0, 0]
    for ds, row in one.items():
        for m in ('psnr', 'ssim', 'nrmse', 'roi_psnr', 'roi_ssim'):
            assert s0[ds][m] == s1[ds][m] == row[m], (ds, m)
    assert [open(f).read() for f in details] == before


def test_gathered_fast_eval_equals_one_process(synth, tmp_path):
    """fast_eval over 3 images in batches of 1 on 2 ranks (rank 0 takes
    batches 0 and 2, rank 1 batch 1): the per-image details, full and
    ROI, and the means are bit for bit those of one process on both
    ranks (x + 0 is exact in the sum over the ranks)."""
    root, names = synth
    p = dict(argv=_argv(root, names), name=names[1])
    codes, res, _ = spawn(fast_eval_rank, 2, tmp_path, p)
    assert codes == [0, 0]
    one = fast_eval_rank(0, 1, p)
    assert one['n'] == 3
    for r in res:
        for key in ('full', 'roi', 'details', 'roi_details'):
            assert r[key] == one[key], key


def test_superstep_probe_leaves_training_as_it_was(synth, tmp_path,
                                                   monkeypatch):
    """K=2 over 104 steps on 2 ranks (the probe's condition: at least
    50 K steps to go): probe on and off give the same final state bit
    for bit; the probe ran (its log line) and chose a K."""
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')   # skip the final tests
    root, names = synth
    finals = {}
    for probe in ('True', 'False'):
        cwd, work = tmp_path / f'c{probe}', tmp_path / f'w{probe}'
        cwd.mkdir()
        work.mkdir()
        argv = _argv(root, names, max_epochs=52, train_steps_per_call=2,
                     train_superstep_probe=probe, checkpoint_eval=1000,
                     checkpoint_save=1000, eval_over_roi_also=False,
                     swinir=False)
        codes, _, _ = spawn(main_rank, 2, work, dict(cwd=str(cwd),
                                                     argv=argv))
        assert codes == [0, 0], probe
        exp = _exp(str(cwd))
        with open(os.path.join(exp, 'log.txt')) as f:
            logged = 'superstep probe' in f.read()
        assert logged == (probe == 'True')
        finals[probe] = _final_params(exp)
    (pa, sa), (pb, sb) = finals['True'], finals['False']
    assert sa == sb == 104
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_regularizers_and_w_sparsity_on_two_ranks(synth, tmp_path,
                                                  monkeypatch):
    """orth and clip act on the parameters after the update, equal on
    every rank, and w_sparsity reads only them: 2 ranks with the three
    on equal the one-process run within 1e-5 (SRCNN, 4 steps: orth on
    steps 2 and 4, clip on step 3)."""
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')   # skip the final tests
    root, names = synth
    argv = _argv(root, names, swinir=False, G_regularizer_orthstep=2,
                 G_regularizer_clipstep=3, w_sparsity=True,
                 w_sparsity_lambda=1e-3, eval_over_roi_also=False)
    one, two = tmp_path / 'one', tmp_path / 'two'
    one.mkdir()
    two.mkdir()
    cwd = os.getcwd()
    try:
        os.chdir(one)
        TMAIN.main(argv)
    finally:
        os.chdir(cwd)
        DLLogger.reset()
    codes, _, _ = spawn(main_rank, 2, tmp_path, dict(cwd=str(two),
                                                     argv=argv))
    assert codes == [0, 0]
    (p1, s1), (p2, s2) = _final_params(_exp(str(one))), \
        _final_params(_exp(str(two)))
    assert s1 == s2 == 4
    assert rel_l2(p2, p1) <= 1e-5
    t1, t2 = _tracker(_exp(str(one))), _tracker(_exp(str(two)))
    np.testing.assert_allclose(t2['train']['period_iter']['w_sparsity'],
                               t1['train']['period_iter']['w_sparsity'],
                               rtol=1e-5)


def test_choose_superstep_matches_jax():
    """tests/test_parallel.py:150's cases, and the port's rule against
    JAX's on a grid of rates."""
    assert choose_superstep(8, rate_k=1000.0, rate_1=900.0) == 8
    assert choose_superstep(8, rate_k=1000.0, rate_1=1040.0) == 8
    assert choose_superstep(8, rate_k=1000.0, rate_1=1051.0) == 1
    assert choose_superstep(4, rate_k=500.0, rate_1=2000.0) == 1
    for k in (2, 8):
        for r1 in np.linspace(800.0, 1200.0, 41):
            assert choose_superstep(k, 1000.0, r1) == j_choose(k, 1000.0, r1)


def test_failing_rank_ends_both_ranks(synth, tmp_path):
    """Rank 1's validation forward turns NaN: its fast_eval flags the
    failure in the all-reduce, so both ranks raise there and exit
    non-zero long before the process group's timeout."""
    root, names = synth
    cwd = tmp_path / 'cwd'
    cwd.mkdir()
    codes, _, seconds = spawn(
        main_rank, 2, tmp_path, dict(cwd=str(cwd), argv=_argv(root, names),
                                     fail_eval_rank=1),
        timeout=3 * PG_TIMEOUT_S)
    assert codes[0] not in (0, None) and codes[1] not in (0, None), codes
    assert seconds < PG_TIMEOUT_S
