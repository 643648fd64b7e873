"""The training options that are off by default, end to end: steps of
the port's make_train_step with all of them (EDT*ROI sampling,
the three LR-only local augs, ppiw with l1, the 13 loss terms) against
JAX's make_train_step from the same params and JAX's draws; a prediction
with a zero derivative vector skipping the step on both sides; `python
-m srcaco2_tpu_torch.main` with every option and both regularizers; and
a superstep whose chunks stop on the regularizers' steps, equal to one
step per call bit for bit."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models import cnn_pre as JCP
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import schedule as JS
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu.train.steps import make_train_step as j_make_train_step
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.data.synthetic import (_cell_image,
                                              make_synthetic_dataset)
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models import cnn_pre as TCP
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train import trainer as TT
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import make_train_step

from test_torch_entry_train import TINY_FLAGS, _tiny_args
from test_torch_local_augs import AUGS, jax_batch_draws
from test_torch_train_step import _signal

ROOT = Path(__file__).resolve().parents[1]
TERMS = dict(l1=True, l2=True, l2sum=True, ssim=True, ssim_window_s=7,
             charbonnier=True, boundpred=True, local_moments=True,
             img_grad=True, norm_img_grad=True, laplace=True,
             norm_laplace=True, loc_var=True, norm_loc_var=True, hist=True,
             hist_metric=JC.KL, kde=True, kde_metric=JC.BH,
             w_sparsity=True, w_sparsity_lambda=1e-3)
OPTIONS = dict(sample_tr_patch=JC.SAMPLE_EDTXROI, ppiw=True, **AUGS)
_NET = dict(upscale=2, window_size=4, embed_dim=16, depths=(2, 2),
            num_heads=(2, 2), upsampler='pixelshuffledirect', in_chans=1,
            mlp_ratio=2.0)


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stacks(n=6, hr_side=48, scale=2, seed=3):
    rng = np.random.default_rng(seed)
    hr = np.stack([_cell_image(rng, hr_side) for _ in range(n)])[..., None]
    lr = np.ascontiguousarray(hr[:, ::scale, ::scale])
    return hr, lr


def test_three_steps_with_every_option_match_jax():
    """SwinIR (fused blocks), batch 4 of 16x16 HR patches, every option:
    three steps after two, each from JAX's state before it: its holder (the 16 terms and
    the total) within 1e-5 (hist 1e-4), and the updated params within
    2e-2 of the learning rate of JAX's (Adam scales the grads' rounding
    differences, which hist's sigmoids magnify; qkv_bias's k third, whose
    grad is rounding noise, left out as in test_torch_train_step.py)."""
    cfg_kw = dict(scale=2, h_size=16, **OPTIONS)
    flags = dict(TERMS, scale=2, h_size=16, n_channels=1, **OPTIONS)
    ja = {**j_get_config(JC.SWINIR), **flags}
    ta = {**t_get_config(), **flags}
    jm = JSwinIR(fused_blocks=True, fused_mode='never', **_NET)
    pn = jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 1, 8, 8)), train=False)[
            'params'])(jax.random.key(0)))
    hr, lr = _stacks()
    table = JP.per_color_weights(hr, 0.001)
    cfg_j = JP.PipeConfig(**cfg_kw)
    tx = JS.build_optimizer(ja['train'])
    js = JTrainState.create(pn, tx)
    jstep = j_make_train_step(jm, j_build_loss(ja), tx, JC.SWINIR, cfg_j,
                              steps_per_epoch=1000,
                              ppiw_table=jnp.asarray(table), donate=False)
    tm = TSwinIR(device='cpu', **_NET)
    tm.load_state_dict(flax_to_torch(pn, tm))
    ttx = TS.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), ttx)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    tmaster = t_build_loss(ta)
    assert len(tmaster.terms) == 16
    tstep = make_train_step(tm, tmaster, ttx, JC.SWINIR,
                            TP.PipeConfig(**cfg_kw), steps_per_epoch=1000,
                            ppiw_table=torch.from_numpy(table))
    key = jax.random.key(4)
    r = np.random.default_rng(5)
    hr_t, lr_t = torch.from_numpy(hr), torch.from_numpy(lr)
    lr_rate = float(ja['train']['G_optimizer_lr'])
    # two JAX steps first: from fresh moments Adam's update of a grad
    # that is rounding noise is +-lr on either side
    for _ in range(2):
        js, _, _ = jstep(js, jnp.asarray(hr), jnp.asarray(lr),
                         jnp.asarray(r.integers(0, len(hr), (4,)),
                                     jnp.int32), key)
    for i in range(2, 5):
        # each step from JAX's state: the port's params and Adam state
        # bridged from it
        with torch.no_grad():
            for k, v in flax_to_torch(jax.tree.map(np.asarray, js.params),
                                      tm).items():
                st.params[k].copy_(v)
        st.opt_state = optax_to_torch(jax.tree.map(np.asarray,
                                                   js.opt_state),
                                      tm, st.opt_state)
        idxs = r.integers(0, len(hr), (4,)).astype(np.int32)
        js, jh, jok = jstep(js, jnp.asarray(hr), jnp.asarray(lr),
                            jnp.asarray(idxs), key)
        draws = jax_batch_draws(jax.random.fold_in(key, i), hr, lr, idxs,
                                cfg_j)
        st, th, tok = tstep(st, hr_t, lr_t, torch.from_numpy(idxs), draws)
        assert bool(jok) and bool(tok)
        assert set(th) == set(jh)
        for k in th:
            # hist's sigmoids (sigma 1e5) turn the predictions' 1e-7
            # differences at bin edges into 1e-5 of the term
            rtol = 1e-4 if k == 'hist' else 1e-5
            np.testing.assert_allclose(float(th[k]), float(jh[k]),
                                       rtol=rtol, atol=1e-6, err_msg=(i, k))
        ref = flax_to_torch(jax.tree.map(np.asarray, js.params), tm)
        for k, v in ref.items():
            np.testing.assert_allclose(
                _signal(k, st.params[k].detach().numpy()), _signal(k, v),
                rtol=0, atol=2e-2 * lr_rate, err_msg=(i, k))


def test_zero_derivative_vector_skips_the_step_on_both_sides():
    """SRCNN on flat images predicts a flat interior, whose image
    gradient vectors are 0: norm_img_grad's grads are NaN on both sides
    (jnp.linalg.norm's), so both steps skip and keep the params."""
    flags = dict(norm_img_grad=True, l2=True, scale=2, h_size=16,
                 n_channels=1)
    ja = {**j_get_config(JC.SRCNN), **flags}
    ta = {**t_get_config(), **flags}
    kw = dict(in_chans=1)
    jm = JCP.SRCNN(**kw)
    pn = jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init(k, jnp.zeros((1, 1, 16, 16)), train=False)[
            'params'])(jax.random.key(0)))
    hr = np.full((2, 32, 32, 1), 90, np.uint8)
    lr = np.full((2, 16, 16, 1), 90, np.uint8)
    idxs = np.array([0, 1], np.int32)
    cfg = dict(scale=2, h_size=16)
    tx = JS.build_optimizer(ja['train'])
    jstep = j_make_train_step(jm, j_build_loss(ja), tx, JC.SRCNN,
                              JP.PipeConfig(**cfg), steps_per_epoch=10,
                              donate=False)
    js, jh, jok = jstep(JTrainState.create(pn, tx), jnp.asarray(hr),
                        jnp.asarray(lr), jnp.asarray(idxs),
                        jax.random.key(0))
    tm = TCP.SRCNN(device='cpu', **kw)
    tm.load_state_dict(flax_to_torch(pn, tm))
    p0 = {k: v.detach().clone() for k, v in tm.named_parameters()}
    ttx = TS.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), ttx)
    tstep = make_train_step(tm, t_build_loss(ta), ttx, JC.SRCNN,
                            TP.PipeConfig(**cfg), steps_per_epoch=10)
    draws = TP.draw(torch.Generator().manual_seed(0), 2,
                    TP.PipeConfig(**cfg), (32, 32))
    st, th, tok = tstep(st, torch.from_numpy(hr), torch.from_numpy(lr),
                        torch.from_numpy(idxs), draws)
    assert float(jh['_skipped']) == float(th['_skipped']) == 1.0
    assert not bool(jok) and not bool(tok)
    assert np.isfinite(float(jh['norm_img_grad']))
    np.testing.assert_allclose(float(th['norm_img_grad']),
                               float(jh['norm_img_grad']), atol=1e-6)
    for k, v in p0.items():
        assert torch.equal(st.params[k], v), k
    for k, v in flax_to_torch(jax.tree.map(np.asarray, js.params),
                              tm).items():
        assert torch.equal(v, p0[k]), k


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth_opts'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=8,
                                   n_val=2, n_test=2, size=64)
    return root, names


def _cli(d):
    out = []
    for k, v in d.items():
        out += [f'--{k}', str(v)]
    return out


def test_main_trains_with_every_option(synth, tmp_path):
    """python -m srcaco2_tpu_torch.main, 2 steps of a tiny SwinIR with
    every option and both regularizers: exit 0, every term logged and
    finite, the orth step's change in the final params."""
    root, names = synth
    argv = ['srcaco2_tpu_torch.main', '--device', 'cpu', '--scale', '2',
            '--h_size', '16', '--n_channels', '1', '--train_dsets',
            names[0], '--valid_dsets', names[1], '--test_dsets', names[2],
            '--data_root', root, '--splits_root', root, '--batch_size', '4',
            '--eval_bsize', '2', '--max_epochs', '1', '--checkpoint_eval',
            '1.0', '--checkpoint_save', '1.0', '--plot_epoch_freq', '0',
            '--G_regularizer_orthstep', '1', '--G_regularizer_clipstep',
            '2', *_cli({k: v for k, v in TERMS.items()}),
            *_cli({k: v for k, v in OPTIONS.items()}), *TINY_FLAGS]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    res = subprocess.run([sys.executable, '-m', *argv], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    exp = next(Path(tmp_path, 'exps').rglob('passed.txt')).parent
    with open(exp / 'tracker.pkl', 'rb') as f:
        tracker = pickle.load(f)
    it = tracker['train']['period_iter']
    assert set(it) >= set(t_build_loss({**t_get_config(),
                                        **TERMS}).names)
    for name, vals in it.items():
        assert len(vals) == 2 and all(np.isfinite(vals)), name
    assert 'non-finite' not in res.stdout


def _regularized_run(synth, exp, spc, calls):
    root, names = synth
    args = _tiny_args(root, names, exp, 2, train_steps_per_call=spc,
                      G_regularizer_orthstep=3, G_regularizer_clipstep=5,
                      **OPTIONS)
    ex = TT.Experiment(args)
    step_fn = ex.train_step

    def counted(state, hr, lr, idxs, draws):
        calls.append((int(state.step), 1 if idxs.ndim == 1
                      else idxs.shape[0]))
        return step_fn(state, hr, lr, idxs, draws)
    ex.train_step = counted
    return ex


def test_superstep_chunks_stop_on_regularizer_steps(synth, tmp_path,
                                                    monkeypatch):
    """4 steps per epoch, 2 epochs, chunks of up to 3 with orth every 3
    and clip every 5 steps: no chunk crosses a multiple of 3 or 5, the
    regularizers run after steps 3, 6 and 5, and the run equals one step
    per call bit for bit."""
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')
    ran = []

    def recorded(name, fn):
        def run(arg):
            ran.append(name)
            return fn(arg)
        return run
    monkeypatch.setattr(TT, 'regularizer_orth',
                        recorded('orth', TT.regularizer_orth))
    monkeypatch.setattr(TT, 'regularizer_clip',
                        recorded('clip', TT.regularizer_clip))
    chunks = []
    ex = _regularized_run(synth, str(tmp_path / 'a'), 3, chunks)
    ex.train_valid()
    ends = [s + k for s, k in chunks]
    assert sum(k for _, k in chunks) == 8 and max(k for _, k in chunks) > 1
    for s, k in chunks:
        for per in (3, 5):
            assert (s // per) == ((s + k - 1) // per), (s, k, per)
    assert {3, 5, 6} <= set(ends)
    assert ran == ['orth', 'clip', 'orth']
    single = _regularized_run(synth, str(tmp_path / 'b'), 1, [])
    single.train_valid()
    for k, p in ex.state.params.items():
        assert torch.equal(p, single.state.params[k]), k
