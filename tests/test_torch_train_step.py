"""The port's training path against the JAX package, in f32: the block
stack and SwinIR in training mode (loss and the grads of every
parameter, through the fused blocks' plain versions on the CPU against
the Pallas kernels in interpret mode), the training-mode path selection
for large inputs, and one whole train step (loss, grads, new
parameters, new Adam state, EMA) from a bridged optimizer state,
including a step skipped for a non-finite loss."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models.swin_fused import FusedBlockStack as JStack
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import schedule as JS
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu.train.steps import make_train_step as j_make_train_step
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.ops import swin_block as tsb
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step

from test_torch_train_parts import jax_draws

C, NH, WS, D = 24, 4, 4, 2


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


def _grads_close(name, got, ref):
    """f32: max abs <= 1e-4 max|ref| + 1e-6."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max() + 1e-6, (name, err)


def _stack_pair(hw, mode, depth=D):
    """(JAX stack, its params as numpy, port stack with them, input)."""
    jm = JStack(C, depth, NH, WS, 2.0, use_pallas=mode)
    x = np.random.default_rng(1).normal(0, 1, (2, *hw, C)).astype(np.float32)
    p = jax.jit(lambda k: jm.init(k, jnp.asarray(x))['params'])(
        jax.random.key(0))
    pn = jax.tree.map(np.asarray, p)
    tm = FusedBlockStack(C, depth, NH, WS, 2.0, device='cpu')
    tm.load_state_dict({k.replace('_scale', '_weight'):
                        torch.from_numpy(np.array(v))
                        for k, v in pn.items()})
    return jm, pn, tm.train(), x


def _stack_grads(jm, pn, tm, x):
    """Loss sum(out * R) and the grads of x and every parameter, both
    sides."""
    r = np.random.default_rng(2).normal(0, 1, x.shape).astype(np.float32)
    lj, (gxj, gpj) = jax.jit(jax.value_and_grad(
        lambda xx, pp: jnp.sum(jm.apply({'params': pp}, xx) * r),
        argnums=(0, 1)))(jnp.asarray(x), pn)
    xt = torch.from_numpy(x).requires_grad_()
    lt = (tm(xt) * torch.from_numpy(r)).sum()
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    _grads_close('x', xt.grad, gxj)
    for k, v in gpj.items():
        _grads_close(k, getattr(tm, k.replace('_scale', '_weight')).grad, v)


@pytest.mark.parametrize('pair,depth', [(False, D), (True, D), (True, 3)])
def test_stack_training_grads_match_jax(monkeypatch, pair, depth):
    """T = 64 <= 256: the fused path (plain K1 / K2 through the autograd
    Function, the bias grad through build_attn_bias's gather into the
    bias tables) against the Pallas path in interpret mode. With
    SRCACO2_SWIN_PAIR=1, read by both stacks, an even depth runs its
    blocks as (no-shift, shift) pairs (plain K3 / K4 against the Pallas
    pair kernel) and an odd depth keeps the per-block path, as in JAX."""
    monkeypatch.setenv('SRCACO2_SWIN_PAIR', '1' if pair else '0')
    jm, pn, tm, x = _stack_pair((8, 8), 'interpret', depth)
    assert tm.pair == pair
    calls = {'pair': 0, 'block': 0}

    def counted(op, name):
        def run(*a, **k):
            calls[name] += 1
            return op(*a, **k)
        return run
    monkeypatch.setattr(tm, 'pair_op', counted(tm.pair_op, 'pair'))
    monkeypatch.setattr(tm, 'fused_op', counted(tm.fused_op, 'block'))
    _stack_grads(jm, pn, tm, x)
    paired = pair and depth % 2 == 0
    assert calls == {'pair': depth // 2 if paired else 0,
                     'block': 0 if paired else depth}


def test_training_never_takes_the_tiled_path(monkeypatch):
    """A tileable input of T > 256 in training mode takes the windowed
    path (the tiled path's grouped block has no backward), and its grads
    match the JAX stack's windowed path."""
    jm, pn, tm, x = _stack_pair((24, 16), 'never')

    def no_grouped(*a, **k):
        raise AssertionError('the training path reached the grouped block')
    monkeypatch.setattr(tm, 'block_op', no_grouped)
    _stack_grads(jm, pn, tm, x)


def test_grouped_block_refuses_grad_off_the_cpu():
    """On a non-CPU tensor (a meta tensor here: no card is needed to
    reach the check) the forward-only grouped block raises when grad
    mode is on and an input requires grad, instead of returning an
    output that carries no grad."""
    x = torch.empty(4, 256, C, device='meta', requires_grad=True)
    p = {k: torch.zeros(s) for k, s in (
        ('ln1_weight', (C,)), ('mlp1_kernel', (C, 2 * C)))}
    with pytest.raises(RuntimeError, match='no backward'):
        tsb.fused_swin_block_grouped(x, p, torch.empty(4, NH, 256, 256),
                                     torch.zeros(4, dtype=torch.int32),
                                     heads=NH)


_NET = dict(upscale=2, window_size=WS, embed_dim=16, depths=(2, 2),
            num_heads=(2, 2), upsampler='pixelshuffledirect')


def _swinir_pair(seed=0):
    jm = JSwinIR(in_chans=1, mlp_ratio=2.0, fused_blocks=True,
                 fused_mode='interpret', **_NET)
    p = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 1, 8, 8)),
                                  train=False)['params'])(
        jax.random.key(seed))
    pn = jax.tree.map(np.asarray, p)
    tm = TSwinIR(in_chans=1, mlp_ratio=2.0, device='cpu', **_NET)
    tm.load_state_dict(flax_to_torch(pn, tm))
    return jm, pn, tm


def _train_args():
    flags = dict(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=19,
                 scale=2, h_size=16, n_channels=1)
    ja = {**j_get_config(JC.SWINIR), **flags}
    ta = {**t_get_config(), **flags}
    ja['train'] = {**ja['train'], 'E_decay': 0.999}
    return ja, ta


def test_swinir_training_loss_and_grads_match_jax():
    """SwinIR in training mode (train=True / model.train()) on 8x8 LR
    patches, l2 + 5 neg-SSIM(19): the loss and the grad of every
    parameter."""
    jm, pn, tm = _swinir_pair()
    ja, ta = _train_args()
    r = np.random.default_rng(3)
    x = r.uniform(0, 1, (3, 1, 8, 8)).astype(np.float32)
    y = r.uniform(0, 1, (3, 1, 16, 16)).astype(np.float32)
    jmaster = j_build_loss(ja)

    def jloss(pp):
        out = jm.apply({'params': pp}, jnp.asarray(x), train=True)
        return jmaster(out, {'h_im': jnp.asarray(y)})[0]
    lj, gj = jax.jit(jax.value_and_grad(jloss))(pn)
    params = dict(tm.named_parameters())
    lt, _, _, gt = loss_and_grads(
        tm, t_build_loss(ta), JC.SWINIR, params,
        {'l_im': torch.from_numpy(x), 'h_im': torch.from_numpy(y)}, 0, 1.0)
    assert tm.training
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gj_t = flax_to_torch(jax.tree.map(np.asarray, gj), tm)
    assert set(gj_t) == set(gt)
    for k in gt:
        _grads_close(k, gt[k], gj_t[k])


class _NanTarget:
    """A master loss whose batch target carries one NaN pixel."""

    def __init__(self, master, torch_side):
        self.master, self.torch_side = master, torch_side

    def __call__(self, outputs, batch, params=None, epoch=0, elb_t=1.0):
        h = batch['h_im']
        if self.torch_side:
            h = h.clone()
            h[0, 0, 0, 0] = float('nan')
        else:
            h = h.at[0, 0, 0, 0].set(jnp.nan)
        return self.master(outputs, {**batch, 'h_im': h}, params, epoch,
                           elb_t)


def _signal(name, a):
    """Drop the k third of qkv_bias: its grad is zero in exact arithmetic
    (a per-row shift of the scores, which the softmax ignores), so Adam
    turns its rounding noise into +-lr updates in both frameworks."""
    a = np.asarray(a)
    if name.endswith('qkv_bias'):
        c = a.shape[-1] // 3
        return np.concatenate([a[..., :c], a[..., 2 * c:]], -1)
    return a


def _state_close(ts, js_state, tm, new_params_tol):
    """Port state against a JAX TrainState: params within
    new_params_tol, the Adam moments and counts, the EMA."""
    jp = flax_to_torch(jax.tree.map(np.asarray, js_state.params), tm)
    for k, v in jp.items():
        np.testing.assert_allclose(
            _signal(k, ts.params[k].detach().numpy()), _signal(k, v),
            rtol=0, atol=new_params_tol)
    adam = next(s for s in js_state.opt_state if hasattr(s, 'mu'))
    sched = [s for s in js_state.opt_state if getattr(s, '_fields', ()) ==
             ('count',)][0]
    assert int(ts.opt_state['adam']['count']) == int(adam.count)
    assert int(ts.opt_state['schedule']['count']) == int(sched.count)
    for f in ('mu', 'nu'):
        ref = flax_to_torch(jax.tree.map(np.asarray, getattr(adam, f)), tm)
        for k, v in ref.items():
            v = v.numpy()
            np.testing.assert_allclose(
                ts.opt_state['adam'][f][k].numpy(), v, rtol=0,
                atol=2e-4 * np.abs(v).max() + 1e-12)
    ema = flax_to_torch(jax.tree.map(np.asarray, js_state.ema_params), tm)
    for k, v in ema.items():
        np.testing.assert_allclose(_signal(k, ts.ema_params[k].numpy()),
                                   _signal(k, v), rtol=0,
                                   atol=new_params_tol)


@pytest.fixture(scope='module')
def after_three_jax_steps():
    """The JAX state after 3 train steps (Adam count 3, non-zero
    moments, an EMA that lags the params) and what the next step
    needs."""
    jm, pn, tm = _swinir_pair(seed=1)
    ja, _ = _train_args()
    r = np.random.default_rng(4)
    hr = jnp.asarray(r.integers(0, 256, (6, 32, 32, 1)), jnp.uint8)
    lr = jnp.asarray(r.integers(0, 256, (6, 16, 16, 1)), jnp.uint8)
    tx = JS.build_optimizer(ja['train'])
    cfg = JP.PipeConfig(scale=2, h_size=16)
    state = JTrainState.create(pn, tx, e_decay=0.999)
    key = jax.random.key(5)
    jstep = j_make_train_step(jm, j_build_loss(ja), tx, JC.SWINIR, cfg,
                              e_decay=0.999, steps_per_epoch=1000,
                              donate=False)
    for i in range(3):
        idxs = jnp.asarray(r.integers(0, 6, (4,)), jnp.int32)
        state, _, _ = jstep(state, hr, lr, idxs, key)
    return dict(jm=jm, tm=tm, ja=ja, hr=hr, lr=lr, tx=tx, cfg=cfg,
                state=state, key=key,
                idxs=jnp.asarray([5, 0, 2, 2], jnp.int32))


def _port_state(ctx, tm):
    """The JAX state carried to the port: params, Adam state and
    schedule count through the bridge, the EMA, the step."""
    js = ctx['state']
    ja = ctx['ja']
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, js.params),
                                     tm))
    ttx = TS.build_optimizer(ja['train'])
    params = dict(tm.named_parameters())
    st = TrainState.create(params, ttx, e_decay=0.999)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    st.ema_params = flax_to_torch(jax.tree.map(np.asarray, js.ema_params),
                                  tm)
    st.step = torch.tensor(int(js.step), dtype=torch.int32)
    return st, ttx


def _port_draws(ctx):
    skey = jax.random.fold_in(ctx['key'], int(ctx['state'].step))
    return jax_draws(skey, ctx['idxs'].shape[0], 32, 16)


def test_one_train_step_matches_jax(after_three_jax_steps):
    """One f32 step from the same state (bridged Adam state, count 3)
    and the same batch (JAX's draws): loss within 1e-5 relative, grads
    within 1e-4 max|g|, new params within 1e-2 lr, the new Adam state,
    the EMA."""
    ctx = after_three_jax_steps
    jm, tm, ja = ctx['jm'], ctx['tm'], ctx['ja']
    js = ctx['state']
    jmaster = j_build_loss(ja)
    jstep = j_make_train_step(jm, jmaster, ctx['tx'], JC.SWINIR, ctx['cfg'],
                              e_decay=0.999, steps_per_epoch=1000,
                              donate=False)
    js2, jh, jok = jstep(js, ctx['hr'], ctx['lr'], ctx['idxs'], ctx['key'])
    # the JAX grads of that step, from its own batch
    jbatch = JP.make_train_batch(ctx['hr'], ctx['lr'], ctx['idxs'],
                                 jax.random.fold_in(ctx['key'],
                                                    int(js.step)),
                                 ctx['cfg'])
    gj = jax.jit(jax.grad(lambda pp: jmaster(
        jm.apply({'params': pp}, jbatch['l_im'], train=True),
        jbatch)[0]))(js.params)

    st, ttx = _port_state(ctx, tm)
    tmaster = t_build_loss(_train_args()[1])
    tcfg = TP.PipeConfig(scale=2, h_size=16)
    hr_t = torch.from_numpy(np.array(ctx['hr']))
    lr_t = torch.from_numpy(np.array(ctx['lr']))
    idxs_t = torch.from_numpy(np.array(ctx['idxs']))
    draws = _port_draws(ctx)
    batch = TP.assemble(hr_t, lr_t, idxs_t, draws, tcfg)
    _, _, _, gt = loss_and_grads(tm, tmaster, JC.SWINIR, st.params, batch,
                                 0, 1.0)
    gj_t = flax_to_torch(jax.tree.map(np.asarray, gj), tm)
    for k in gt:
        _grads_close(k, gt[k], gj_t[k])
    tstep = make_train_step(tm, tmaster, ttx, JC.SWINIR, tcfg,
                            e_decay=0.999, steps_per_epoch=1000)
    st, th, tok = tstep(st, hr_t, lr_t, idxs_t, draws)
    assert bool(tok) and bool(jok)
    np.testing.assert_allclose(float(th['total']), float(jh['total']),
                               rtol=1e-5)
    assert float(th['_flags']) == float(jh['_flags']) == 0.0
    assert int(st.step) == int(js2.step) == 4
    _state_close(st, js2, tm, new_params_tol=1e-2 * 2e-4)


def test_nan_step_is_skipped_as_in_jax(after_three_jax_steps):
    """A NaN in the batch target: the skip flag is set, the params stay,
    the Adam moments decay on zero grads, the counts advance and the EMA
    moves towards the unchanged params, as in JAX."""
    ctx = after_three_jax_steps
    jm, tm, ja = ctx['jm'], ctx['tm'], ctx['ja']
    jstep = j_make_train_step(jm, _NanTarget(j_build_loss(ja), False),
                              ctx['tx'], JC.SWINIR, ctx['cfg'],
                              e_decay=0.999, steps_per_epoch=1000,
                              donate=False)
    js2, jh, jok = jstep(ctx['state'], ctx['hr'], ctx['lr'], ctx['idxs'],
                         ctx['key'])
    st, ttx = _port_state(ctx, tm)
    before = {k: p.detach().clone() for k, p in st.params.items()}
    ema_before = {k: e.clone() for k, e in st.ema_params.items()}
    tstep = make_train_step(tm, _NanTarget(t_build_loss(_train_args()[1]),
                                           True), ttx, JC.SWINIR,
                            TP.PipeConfig(scale=2, h_size=16),
                            e_decay=0.999, steps_per_epoch=1000)
    st, th, tok = tstep(st, torch.from_numpy(np.array(ctx['hr'])),
                        torch.from_numpy(np.array(ctx['lr'])),
                        torch.from_numpy(np.array(ctx['idxs'])),
                        _port_draws(ctx))
    assert not bool(tok) and not bool(jok)
    assert float(th['_skipped']) == float(jh['_skipped']) == 1.0
    assert float(th['_corrupt']) == float(jh['_corrupt']) == 0.0
    for k, p in st.params.items():
        assert torch.equal(p.detach(), before[k]), k
    assert any(not torch.equal(st.ema_params[k], ema_before[k])
               for k in before)
    _state_close(st, js2, tm, new_params_tol=1e-6)
