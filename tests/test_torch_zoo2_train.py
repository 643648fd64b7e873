"""One training step of NLSN, GRL, DRRN and MemNet through the port's
make_train_step (f32) against the JAX package's at small sizes, as
tests/test_torch_zoo_train.py holds the first part of the zoo: the same
params, fresh Adam state and batch; l2 + 5 neg-SSIM(7); the JAX step in
float64 (jax x64). Held: the loss terms within 1e-5, the grads within
1e-4 of max|g| (JAX's read from its first Adam moment), the updated
params and moments; MemNet's running statistics after the step against
JAX's model_state (updated once, by the step's forward); NLSN with the
same rotations on both sides (injected into JAX's jitted step through a
wrapper around jax.random.normal). Also: the superstep of two steps
equals two single steps bit for bit for the stateful nets (MemNet's
statistics, NLSN's rotation generators from the draws), and the
command line's remat options reach the models."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models import cnn_pre as JC
from srcaco2_tpu.models import grl as JG
from srcaco2_tpu.models import nlsn as JN
from srcaco2_tpu.train import schedule as JSCH
from srcaco2_tpu.train import steps as JST
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config import parser as TPARSE
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models import cnn_pre as TC
from srcaco2_tpu_torch.models import grl as TG
from srcaco2_tpu_torch.models import nlsn as TN
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import schedule as TSCH
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step
from srcaco2_tpu_torch.utils import reproducibility as R

from test_torch_train_parts import jax_draws
from test_torch_zoo2 import _Recorder
from test_torch_zoo_train import _close, _flags

_GRL = dict(in_chans=1, upscale=2, embed_dim=16, depths=(2,),
            num_heads_window=(2,), num_heads_stripe=(2,), window_size=4,
            stripe_size=(4, 4))
_MEM = dict(in_chans=1, upscale=2, num_memory_blocks=2,
            num_residual_blocks=2, features=8)
_NLSN = dict(in_chans=1, upscale=2, n_resblocks=8, n_feats=16, n_hashes=2,
             chunk_size=16)

# net: (JAX class, port class, kwargs, scale, HR patch size)
NETS = {
    'DRRN': (JC.DRRN, TC.DRRN, dict(in_chans=1, upscale=2,
                                    num_residual_units=3, features=8), 2, 16),
    'MemNet': (JC.MemNet, TC.MemNet, _MEM, 2, 16),
    'NLSN': (JN.NLSN, TN.NLSN, _NLSN, 2, 16),
    'GRL': (JG.GRL, TG.GRL, _GRL, 2, 16),
}
B = 2


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rotations(n_layers, shape, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(n_layers)]


@pytest.mark.parametrize('nt', sorted(NETS))
def test_one_train_step_matches_jax(nt, monkeypatch):
    monkeypatch.setenv('SRCACO2_GRL_MERGED', '0')
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
    tm = tcls(device='cpu', **kw)
    rots = None
    if tcls is TN.NLSN:
        shape = tm.NonLocalSparseAttention_0.rotation_shape(
            (hs // scale) ** 2)
        rots = _rotations(kw['n_resblocks'] // 8 + 1, shape)
        rec = _Recorder(monkeypatch, inject=rots)
    with jax.enable_x64(True):
        jbatch = JP.make_train_batch(hr, lr, idxs,
                                     jax.random.fold_in(key, 0), cfg)
        jm = jcls(dtype=jnp.float64, **kw)
        v = jax.tree.map(np.asarray, jax.jit(
            lambda k, t: jm.init(k, t, train=False))(
            jax.random.key(0), JST.net_input(nt, jbatch)))
        pn = v['params']
        ms = {k: a for k, a in v.items() if k != 'params'} or None
        tx = JSCH.build_optimizer(ja['train'])
        js = JTrainState.create(pn, tx, model_state=ms)
        jstep = JST.make_train_step(jm, j_build_loss(ja), tx, nt, cfg,
                                    steps_per_epoch=1000, donate=False)
        js2, jh, jok = jstep(js, hr, lr, idxs, key)
        draws = jax_draws(jax.random.fold_in(key, 0), B, hr_hw, hs)
    if rots is not None:
        assert len(rec.drawn) >= len(rots)
        tm.rotations = rots

    b1 = float(ja['train']['G_optimizer_beta1'])
    wd = float(ja['train']['G_optimizer_wd'])
    adam = next(s for s in js2.opt_state if hasattr(s, 'mu'))
    mu = flax_to_torch(jax.tree.map(np.asarray, adam.mu), tm)
    p0 = flax_to_torch(pn, tm)
    gj = {k: mu[k] / (1 - b1) - wd * p0[k] for k in mu}
    tm.load_state_dict(flax_to_torch(pn, tm, model_state=ms))
    ttx = TSCH.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), ttx)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    tmaster = t_build_loss(ta)
    tcfg = TP.PipeConfig(scale=scale, h_size=hs)
    hr_t, lr_t = (torch.from_numpy(np.array(a)) for a in (hr, lr))
    idxs_t = torch.from_numpy(np.array(idxs))
    batch = TP.assemble(hr_t, lr_t, idxs_t, draws, tcfg)
    bufs = {k: b.clone() for k, b in tm.named_buffers()}
    _, _, _, gt = loss_and_grads(tm, tmaster, nt, st.params, batch, 0, 1.0)
    assert set(gt) == set(gj)
    for k in gt:
        _close(k, gt[k], gj[k])
    with torch.no_grad():       # the statistics as before that forward
        for k, b in tm.named_buffers():
            b.copy_(bufs[k])
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
    if ms:
        new_ms = jax.tree.map(np.asarray, js2.model_state)
        want = flax_to_torch(pn, tm, model_state=new_ms)
        moved = 0
        for k, b in tm.named_buffers():
            np.testing.assert_allclose(b.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            moved += not torch.equal(b, bufs[k])
        assert moved == len(bufs)


def _port_run(nt, kw, k_steps, superstep):
    """k_steps steps of the port's step on one seeded model: one call of
    the superstep, or k_steps calls of the single step. (params, buffers,
    stacked holder)."""
    tcls = NETS[nt][1]
    tm = tcls(device='cpu', **kw)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    args = _flags(2, 16)[1]
    tx = TSCH.build_optimizer(args['train'])
    st = TrainState.create(dict(tm.named_parameters()), tx)
    cfg = TP.PipeConfig(scale=2, h_size=16)
    g = torch.Generator().manual_seed(1)
    hr = torch.randint(0, 256, (4, 32, 32, 1), generator=g,
                       dtype=torch.uint8)
    lr = torch.randint(0, 256, (4, 16, 16, 1), generator=g,
                       dtype=torch.uint8)
    idxs = torch.tensor([[0, 1], [2, 3], [1, 2]])[:k_steps]
    draws = [TP.draw(R.step_generator(3, j, 'cpu'), 2, cfg, (32, 32))
             ._replace(lsh=R.lsh_generator(3, j)) for j in range(k_steps)]
    step = make_train_step(tm, t_build_loss(args), tx, nt, cfg,
                           steps_per_epoch=1000,
                           steps_per_call=k_steps if superstep else 1)
    if superstep:
        st, holder, _ = step(st, hr, lr, idxs, draws)
    else:
        hs = []
        for j in range(k_steps):
            st, h, _ = step(st, hr, lr, idxs[j], draws[j])
            hs.append(h)
        holder = {k: torch.stack([h[k] for h in hs]) for k in hs[0]}
    return ({k: p.detach().clone() for k, p in st.params.items()},
            {k: b.clone() for k, b in tm.named_buffers()}, holder)


@pytest.mark.parametrize('nt', ['MemNet', 'NLSN'])
def test_superstep_equals_single_steps(nt):
    kw = NETS[nt][2]
    a = _port_run(nt, kw, 3, superstep=True)
    b = _port_run(nt, kw, 3, superstep=False)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), (nt, k)
    if nt == 'MemNet':
        assert len(a[1]) > 0


def test_nlsn_steps_draw_their_own_rotations():
    """The step's rotations come from draws.lsh: two steps from the same
    weights and batch with different generators give different losses
    (the hash moves), the same generator seed the same loss."""
    args = _flags(2, 16)[1]
    cfg = TP.PipeConfig(scale=2, h_size=16)
    g = torch.Generator().manual_seed(1)
    hr = torch.randint(0, 256, (2, 16, 16, 1), generator=g,
                       dtype=torch.uint8)
    lr = torch.randint(0, 256, (2, 8, 8, 1), generator=g,
                       dtype=torch.uint8)
    losses = []
    for seed in (1, 2, 1):
        tm = TN.NLSN(device='cpu', **dict(_NLSN, n_hashes=1))
        tm.reset_parameters(torch.Generator().manual_seed(0))
        tx = TSCH.build_optimizer(args['train'])
        st = TrainState.create(dict(tm.named_parameters()), tx)
        step = make_train_step(tm, t_build_loss(args), tx, 'NLSN', cfg)
        d = TP.Draws(torch.tensor([0, 0]), torch.tensor([0, 0]),
                     torch.tensor([0, 0]), lsh=R.lsh_generator(seed, 0))
        _, h, _ = step(st, hr, lr, torch.tensor([0, 1]), d)
        losses.append(float(h['total']))
    assert losses[0] == losses[2] != losses[1]
    assert tm.lsh_generator is None


@pytest.mark.parametrize('nt,flag,attr,default', [
    ('SRFBN', 'srfbn_remat_steps', 'remat_steps', False),
    ('MemNet', 'memnet_remat_passes', 'remat_passes', True)])
def test_remat_options_reach_the_model(nt, flag, attr, default):
    def built(argv):
        args = TPARSE.get_args(['--net_type', nt, '--scale', '2',
                                '--h_size', '16', '--n_channels', '1',
                                *argv])
        m = t_define_g(args, 'cpu')
        return m if nt == 'SRFBN' else m.memblock0
    assert getattr(built([]), attr) is default
    assert getattr(built([f'--{flag}', str(not default)]), attr) \
        is (not default)
