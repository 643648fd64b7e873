"""One training step of DBPN, ProSR, DSR-Splines, CSR-CNN and EDSR-LIIF
through the port's make_train_step (f32) against the JAX package's at
small widths, as tests/test_torch_zoo_train.py holds the first part of
the zoo: the same params (bridge.flax_to_torch), the same fresh Adam
state (optax_to_torch), the same batch (JAX's draws); the JAX step in
float64 (jax x64). Held: every loss term within 1e-5, the grads within
1e-4 of max|g| (JAX's read from its first Adam moment), the updated
params and moments. The losses: l2 + 5 neg-SSIM(7) (ProSR over its
progressive levels), CSR-CNN's segmentation task with ce (and l2 on its
expectation), DSR-Splines' l2 on the global residual
(l2_use_residuals). Also: the ce term alone against JAX's in f32 and
bf16, and DBPN's remat option through the command line."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models import csrcnn as JC
from srcaco2_tpu.models import dbpn as JD
from srcaco2_tpu.models import dsr_splines as JS
from srcaco2_tpu.models import edsr_liif as JL
from srcaco2_tpu.models import prosr as JPR
from srcaco2_tpu.train import schedule as JSCH
from srcaco2_tpu.train import steps as JST
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config import parser as TPARSE
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models import csrcnn as TC
from srcaco2_tpu_torch.models import dbpn as TD
from srcaco2_tpu_torch.models import dsr_splines as TS
from srcaco2_tpu_torch.models import edsr_liif as TL
from srcaco2_tpu_torch.models import prosr as TPR
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import schedule as TSCH
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step

from test_torch_train_parts import jax_draws
from test_torch_zoo import BF16_TOL
from test_torch_zoo_train import _close, _flags

_UNET = dict(in_planes=1, upscale=2, net_type='unet', inner_channel=8,
             res_blocks=1)
_SEG = dict(ce=True, ce_lambda=1.0, l2=True, ssim=False)
_RES = dict(l2=True, l2_use_residuals=True, ssim=False)

# net: (JAX class, port class, kwargs, scale, HR patch size, flags over
# _flags')
NETS = {
    'DBPN': (JD.DBPN, TD.DBPN, dict(in_chans=1, upscale=2, base_filter=8,
                                    feat=16, num_stages=2), 2, 16, {}),
    # x4: the final loss and one intermediate level's
    'ProSR': (JPR.ProSR, TPR.ProSR,
              dict(in_chans=1, upscale=4, num_init_features=16,
                   growth_rate=8, bn_size=2,
                   level_config={4: [[2], [2]]}), 4, 16, {}),
    'DSRSplines': (JS.DSRSplines, TS.DSRSplines,
                   dict(in_planes=1, upscale=2, n_splines_per_color=8,
                        splinenet_type='snet_type2', use_local_residual=True,
                        use_global_residual=True), 2, 16, _RES),
    'CSRCNN': (JC.CSRCNN, TC.CSRCNN, _UNET, 2, 16, {}),
    'CSRCNN_seg': (JC.CSRCNN, TC.CSRCNN,
                   dict(_UNET, net_task='segmentation'), 2, 16, _SEG),
    'CSRCNN_snet3': (JC.CSRCNN, TC.CSRCNN,
                     dict(_UNET, net_type='snet_type3'), 2, 16, {}),
    'EDSR_LIIF': (JL.EDSRLIIF, TL.EDSRLIIF,
                  dict(in_chans=1, upscale=2, n_feats=8, n_resblocks=2,
                       hidden=16), 2, 16, {}),
}
B = 2


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('name', sorted(NETS))
def test_one_train_step_matches_jax(name):
    jcls, tcls, kw, scale, hs, extra = NETS[name]
    nt = name.split('_seg')[0].split('_snet')[0]
    ja, ta = _flags(scale, hs)
    ja.update(extra)
    ta.update(extra)
    r = np.random.default_rng(4)
    n_img, hr_hw = 4, 2 * hs
    hr = jnp.asarray(r.integers(0, 256, (n_img, hr_hw, hr_hw, 1)), jnp.uint8)
    lr = jnp.asarray(r.integers(0, 256, (n_img, hr_hw // scale,
                                         hr_hw // scale, 1)), jnp.uint8)
    idxs = jnp.asarray([3, 0], jnp.int32)
    key = jax.random.key(5)
    cfg = JP.PipeConfig(scale=scale, h_size=hs)
    with jax.enable_x64(True):
        jbatch = JP.make_train_batch(hr, lr, idxs,
                                     jax.random.fold_in(key, 0), cfg)
        jm = jcls(dtype=jnp.float64, **kw)
        pn = jax.tree.map(np.asarray, jax.jit(
            lambda k, t: jm.init(k, t, train=False)['params'])(
            jax.random.key(0), JST.net_input(nt, jbatch)))
        tx = JSCH.build_optimizer(ja['train'])
        js = JTrainState.create(pn, tx)
        jstep = JST.make_train_step(jm, j_build_loss(ja), tx, nt, cfg,
                                    steps_per_epoch=1000, donate=False)
        js2, jh, jok = jstep(js, hr, lr, idxs, key)
        draws = jax_draws(jax.random.fold_in(key, 0), B, hr_hw, hs)

    tm = tcls(device='cpu', **kw)
    b1 = float(ja['train']['G_optimizer_beta1'])
    wd = float(ja['train']['G_optimizer_wd'])
    adam = next(s for s in js2.opt_state if hasattr(s, 'mu'))
    mu = flax_to_torch(jax.tree.map(np.asarray, adam.mu), tm)
    p0 = flax_to_torch(pn, tm)
    gj = {k: mu[k] / (1 - b1) - wd * p0[k] for k in mu}
    tm.load_state_dict(p0)
    ttx = TSCH.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), ttx)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    tmaster = t_build_loss(ta)
    tcfg = TP.PipeConfig(scale=scale, h_size=hs)
    hr_t, lr_t = (torch.from_numpy(np.array(a)) for a in (hr, lr))
    idxs_t = torch.from_numpy(np.array(idxs))
    batch = TP.assemble(hr_t, lr_t, idxs_t, draws, tcfg)
    _, _, _, gt = loss_and_grads(tm, tmaster, nt, st.params, batch, 0, 1.0)
    assert set(gt) == set(gj)
    for k in gt:
        _close(k, gt[k], gj[k])
    tstep = make_train_step(tm, tmaster, ttx, nt, tcfg, steps_per_epoch=1000)
    st, th, tok = tstep(st, hr_t, lr_t, idxs_t, draws)
    assert bool(tok) and bool(jok)
    assert set(th) == set(jh)
    for k in th:
        np.testing.assert_allclose(float(th[k]), float(jh[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    lr_ = float(ja['train']['G_optimizer_lr'])
    newp = flax_to_torch(jax.tree.map(np.asarray, js2.params), tm)
    for k, val in newp.items():
        live = np.abs(mu[k].numpy() / (1 - b1)) > 1e-5
        d = np.abs(st.params[k].detach().numpy() - val.numpy())
        assert d[live].max(initial=0) <= 1e-2 * lr_, k
        assert d.max(initial=0) <= 2.0 * lr_ + 1e-7, k
        _close(k, st.opt_state['adam']['mu'][k], mu[k])


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_ce_term_matches_jax(dtype):
    """The ce term alone (its value and its grad through the logits)
    against JAX's, on 256-level logits and a uint8-level target."""
    jdt = jnp.float32 if dtype == 'f32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    r = np.random.default_rng(6)
    logits = (3 * r.standard_normal((2, 256, 5, 6))).astype(np.float32)
    y = (r.integers(0, 256, (2, 1, 5, 6)) / 255.0).astype(np.float32)
    flags = dict(ce=True, ce_lambda=1.0, l2=False, ssim=False)
    ja, ta = _flags(2, 16)
    ja.update(flags)
    ta.update(flags)
    jl = j_build_loss(ja)

    def jfn(lg):
        return jl({'out': jnp.asarray(y), 'raw_segmentation': lg},
                  {'h_im': jnp.asarray(y)})[0]
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(logits, jdt))
    lt = torch.from_numpy(logits).to(tdt).requires_grad_()
    tv, th = t_build_loss(ta)({'out': torch.from_numpy(y),
                               'raw_segmentation': lt},
                              {'h_im': torch.from_numpy(y)})
    tv.backward()
    assert set(th) == {'ce', 'total'}
    tol = 1e-6 if dtype == 'f32' else BF16_TOL
    assert abs(float(tv) - float(jv)) <= tol * abs(float(jv))
    g, want = lt.grad.float().numpy(), np.asarray(jg, np.float32)
    assert np.abs(g - want).max() <= tol * np.abs(want).max()


def test_dbpn_remat_option_reaches_the_model():
    def built(argv):
        args = TPARSE.get_args(['--net_type', 'DBPN', '--scale', '2',
                                '--h_size', '16', '--n_channels', '1',
                                '--dbpn_num_stages', '1', *argv])
        return t_define_g(args, 'cpu')
    assert built([]).remat_blocks is True
    assert built(['--dbpn_remat_blocks', 'False']).remat_blocks is False
