"""One training step of each zoo net through the port's make_train_step
(f32) against the JAX package's at small sizes: the same params
(bridge.flax_to_torch), the same fresh Adam state (optax_to_torch), the
same batch (JAX's draws), l2 + 5 neg-SSIM(7). Held: the loss and every
per-term value of the holder within 1e-5 (SRFBN's curriculum over its
steps and MSLapSRN's progressive levels included), the grads within
1e-4 of max|g| (JAX's read from its first Adam moment), the
Adam-updated params and moments; also the per-net
defaults (init_net_g) and the networks define_g builds.

The JAX step runs with its compute dtype float64 (jax x64; params,
grads and the Adam state stay f32): a ReLU network's f32 grads are not
a function of its inputs alone near a kink. In VDSR at this batch, on
the CPU, one pre-activation of layer 15 lies within 1e-6 of zero, XLA's
f32 sums put it on the other side, and JAX's f32 grads of the 15 layers
below move by 1-2%; the port's f32 grads agree with float64 there to
1e-6."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.config.net_defaults import init_net_g as j_init_net_g
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models import act as JA
from srcaco2_tpu.models import cnn_pre as JCP
from srcaco2_tpu.models import dfcan as JD
from srcaco2_tpu.models import enlcn as JE
from srcaco2_tpu.models import mslapsr as JM
from srcaco2_tpu.models import omnisr as JO
from srcaco2_tpu.models import srfbn as JS
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu.train import schedule as JSCH
from srcaco2_tpu.train import steps as JST
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu_torch import constants as TC
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.config.net_defaults import (PORTED_NETS,
                                                   init_net_g as t_init_net_g)
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models import act as TA
from srcaco2_tpu_torch.models import cnn_pre as TCP
from srcaco2_tpu_torch.models import dfcan as TD
from srcaco2_tpu_torch.models import enlcn as TE
from srcaco2_tpu_torch.models import mslapsr as TM
from srcaco2_tpu_torch.models import omnisr as TO
from srcaco2_tpu_torch.models import srfbn as TS
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import schedule as TSCH
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step

from test_torch_train_parts import jax_draws
from test_torch_zoo import enlcn_projection

ZOO = [n for n in PORTED_NETS if n != TC.SWINIR]
_ACT = dict(in_chans=1, n_feats=8, n_resgroups=2, n_resblocks=1,
            reduction=4, n_heads=4, n_layers=4, n_fusionblocks=2,
            token_size=3, expansion_ratio=2)

# net: (JAX class, port class, kwargs, scale, HR patch size)
NETS = {
    'SRCNN': (JCP.SRCNN, TCP.SRCNN, dict(in_chans=1), 2, 16),
    'VDSR': (JCP.VDSR, TCP.VDSR, dict(in_chans=1, upscale=2), 2, 16),
    'DFCAN': (JD.DFCAN, TD.DFCAN, dict(in_chans=1, upscale=2,
                                       n_resgroups=1), 2, 16),
    # x4: one intermediate level (the final loss plus one level's)
    'MSLapSRN': (JM.MSLapSRN, TM.MSLapSRN, dict(in_chans=1, upscale=4), 4,
                 16),
    'SRFBN': (JS.SRFBN, TS.SRFBN, dict(in_chans=1, upscale=2,
                                       num_features=8, num_steps=3,
                                       num_groups=2), 2, 16),
    'ENLCN': (JE.ENLCN, TE.ENLCN, dict(in_chans=1, upscale=2,
                                       n_resblocks=8, n_feats=16,
                                       res_scale=0.1), 2, 16),
    'ACT': (JA.ACT, TA.ACT, dict(upscale=2, **_ACT), 2, 18),
    'OmniSR': (JO.OmniSR, TO.OmniSR, dict(in_chans=1, upscale=2,
                                          num_feat=16, res_num=1,
                                          block_num=1, window_size=4,
                                          pe=True), 2, 16),
}
B = 2


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(name, got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max() + 1e-7, (name, err)


def _flags(scale, h_size):
    flags = dict(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=7,
                 scale=scale, h_size=h_size, n_channels=1)
    return {**j_get_config(), **flags}, {**t_get_config(), **flags}


@pytest.mark.parametrize('nt', sorted(NETS))
def test_one_train_step_matches_jax(nt):
    jcls, tcls, kw, scale, hs = NETS[nt]
    ja, ta = _flags(scale, hs)
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
        jmaster = j_build_loss(ja)
        tx = JSCH.build_optimizer(ja['train'])
        js = JTrainState.create(pn, tx)
        jstep = JST.make_train_step(jm, jmaster, tx, nt, cfg,
                                    steps_per_epoch=1000, donate=False)
        js2, jh, jok = jstep(js, hr, lr, idxs, key)
        draws = jax_draws(jax.random.fold_in(key, 0), B, hr_hw, hs)
        # JAX's ENLCA draws its projection in the x64 mode's dtype
        proj = enlcn_projection(kw['n_feats']) if tcls is TE.ENLCN \
            else None

    tm = tcls(device='cpu', **kw)
    # JAX's grads, read from its first Adam moment: from zero moments one
    # step gives mu = (1 - b1) (g + wd p) (add_decayed_weights, then
    # scale_by_adam)
    b1 = float(ja['train']['G_optimizer_beta1'])
    wd = float(ja['train']['G_optimizer_wd'])
    adam = next(s for s in js2.opt_state if hasattr(s, 'mu'))
    mu = flax_to_torch(jax.tree.map(np.asarray, adam.mu), tm)
    p0 = flax_to_torch(pn, tm)
    gj = {k: mu[k] / (1 - b1) - wd * p0[k] for k in mu}
    tm.load_state_dict(flax_to_torch(pn, tm, projection=proj))
    ttx = TSCH.build_optimizer(ta['train'])
    params = dict(tm.named_parameters())
    st = TrainState.create(params, ttx)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    tmaster = t_build_loss(ta)
    tcfg = TP.PipeConfig(scale=scale, h_size=hs)
    hr_t, lr_t = (torch.from_numpy(np.array(a)) for a in (hr, lr))
    idxs_t = torch.from_numpy(np.array(idxs))
    batch = TP.assemble(hr_t, lr_t, idxs_t, draws, tcfg)
    _, th0, _, gt = loss_and_grads(tm, tmaster, nt, st.params, batch, 0, 1.0)
    assert set(gt) == set(gj)
    for k in gt:
        _close(k, gt[k], gj[k])
    tstep = make_train_step(tm, tmaster, ttx, nt, tcfg, steps_per_epoch=1000)
    st, th, tok = tstep(st, hr_t, lr_t, idxs_t, draws)
    assert bool(tok) and bool(jok)
    assert set(th) == set(jh) == {'l2', 'ssim', 'total', '_skipped',
                                  '_corrupt', '_flags'}
    for k in th:
        np.testing.assert_allclose(float(th[k]), float(jh[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        if k in th0:        # loss_and_grads' holder: the step's values
            assert float(th0[k].detach()) == float(th[k]), k

    # Adam's first step moves each parameter by lr * u / (|u| + eps), u
    # the grad plus weight decay: within 1e-2 lr where |u| > 1e-5 (1000
    # eps, where the step is +-lr to 0.1%), within 2 lr where u is small
    # enough for the grads' tolerated difference to flip its sign
    lr_ = float(ja['train']['G_optimizer_lr'])
    newp = flax_to_torch(jax.tree.map(np.asarray, js2.params), tm)
    assert int(st.opt_state['adam']['count']) == int(adam.count) == 1
    for k, v in newp.items():
        live = np.abs(mu[k].numpy() / (1 - b1)) > 1e-5
        d = np.abs(st.params[k].detach().numpy() - v.numpy())
        assert d[live].max(initial=0) <= 1e-2 * lr_, k
        assert d.max(initial=0) <= 2.0 * lr_ + 1e-7, k
        _close(k, st.opt_state['adam']['mu'][k], mu[k])


@pytest.mark.parametrize('nt', ZOO)
def test_init_net_g_matches_jax(nt):
    args = {'scale': 8, 'n_channels': 1, 'h_size': 128, 'color_min': 0,
            'color_max': 255}
    assert t_init_net_g({'net_type': nt}, args) == \
        j_init_net_g({'net_type': nt}, args)


def test_other_nets_raise():
    """Every net of the zoo is ported; another name raises."""
    assert set(PORTED_NETS) == set(TC.MODELS)
    args = {'scale': 8, 'n_channels': 1, 'h_size': 128}
    with pytest.raises(NotImplementedError, match='no such net'):
        t_init_net_g({'net_type': 'EDSR'}, args)
    with pytest.raises(NotImplementedError, match='no such net'):
        t_define_g({'netG': {'net_type': 'EDSR'}}, 'cpu')


@pytest.mark.parametrize('nt', ZOO)
def test_define_g_builds_the_jax_network(nt):
    """define_g at the full default width (x2, one channel): the port's
    state_dict names and shapes are the bridged JAX init's, exactly."""
    args = {'scale': 2, 'n_channels': 1, 'h_size': 32, 'amp': False,
            'color_min': 0, 'color_max': 255}
    args['netG'] = j_init_net_g({'net_type': nt}, args)
    jm = j_define_g(args)
    lr_hw = 32 if nt in (TC.SRCNN, TC.CSRCNN) else 16
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 1, lr_hw, lr_hw)), train=False)['params'],
        jax.random.key(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = t_define_g(args, 'cpu')
    assert not tm.training
    got = flax_to_torch(zeros, tm)
    params = dict(tm.named_parameters())
    assert set(got) == set(params)
    assert all(got[k].shape == params[k].shape for k in got)


def test_training_after_an_inference_mode_forward():
    """An eval forward under torch.inference_mode builds OmniSR's cached
    relative position index and ESA resize weights first; a training
    step after it still backpropagates through them (an inference tensor
    saved for backward would raise)."""
    from srcaco2_tpu_torch.models import swinir as TSW
    from srcaco2_tpu_torch.ops import resize as TR
    TR._weights_on.cache_clear()
    TSW._rel_index_on.cache_clear()
    _, tcls, kw, _, _ = NETS['OmniSR']
    tm = tcls(device='cpu', **kw)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand((1, 1, 8, 8), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        tm.eval()(x)
    tm.train()
    tm(x)['out'].square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())
