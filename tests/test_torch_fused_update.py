"""ops/fused_update.py on the CPU: the pass's plain version (the kernels'
per-element order and scalar prologue) against the eager chain and
optax, the non-finite skip and the corruption flag, the path rule and
the leaf table. The kernels themselves run in
test_torch_fused_update_chip.py, on the card."""
import ctypes

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.train import schedule as JS
from srcaco2_tpu.train import state as JST
from srcaco2_tpu_torch.ops import fused_update as FU
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train import steps as TSTEPS
from srcaco2_tpu_torch.train.state import TrainState, all_finite

SHAPES = {'w': (6, 5), 'b': (5,), 'g': (3, 2, 2)}


def _train_cfg(**kw):
    tr = dict(j_get_config(JC.SWINIR)['train'])
    tr.update(kw)
    return tr


CHAINS = {
    # the benchmark cell's chain: Adam, L2 decay 1e-4, MultiStepLR
    'adam_wd': (_train_cfg(G_optimizer_wd=1e-4), 0.0),
    'amsgrad_clip_mystep_warmup': (_train_cfg(
        G_optimizer_amsgrad=True, G_optimizer_clipgrad=0.5,
        G_scheduler_type=JC.MYSTEPLR, G_scheduler_step_size=2,
        G_scheduler_min_lr=1e-5, G_scheduler_warmup=3), 0.0),
    'sgd_nesterov': (_train_cfg(
        G_optimizer_type=JC.SGD, G_optimizer_momentum=0.9,
        G_optimizer_nesterov=True, G_optimizer_wd=1e-4), 0.0),
    'sgd_plain_clip': (_train_cfg(
        G_optimizer_type=JC.SGD, G_optimizer_momentum=0.0,
        G_optimizer_clipgrad=2.0), 0.0),
    'adam_multistep_crossed_ema': (_train_cfg(
        G_scheduler_type=JC.MULTISTEPLR, G_scheduler_milestones=[3, 1, 3],
        G_scheduler_gamma=0.5, G_scheduler_warmup=2), 0.99),
}


def _arrays(seed):
    r = np.random.default_rng(seed)
    return {k: r.normal(0, 1, s).astype(np.float32)
            for k, s in SHAPES.items()}


def _state(tx, e_decay, seed=0):
    params = {k: torch.from_numpy(v) for k, v in _arrays(seed).items()}
    return TrainState.create(params, tx, e_decay=e_decay)


def _eager(tx, state, loss, grads, e_decay):
    """The train step's eager path: the finite check, the mask, the
    chain, the masked update, the EMA and the corruption check."""
    ok = torch.isfinite(loss) & all_finite(grads)
    safe = {k: torch.where(ok, g, torch.zeros_like(g))
            for k, g in grads.items()}
    TSTEPS._eager_update(tx, state, safe, ok, e_decay)
    return bool(ok), bool(~all_finite(state.params))


def _leaves(state):
    """Every tensor a step changes, by a flat name."""
    out = {f'p.{k}': v for k, v in state.params.items()}
    for group, st in state.opt_state.items():
        for f, v in st.items():
            if torch.is_tensor(v):
                out[f'{group}.{f}'] = v
            else:
                out.update({f'{group}.{f}.{k}': t for k, t in v.items()})
    if state.ema_params is not None:
        out.update({f'ema.{k}': v for k, v in state.ema_params.items()})
    return out


def _close(got, want, rtol=1e-6):
    for k, v in want.items():
        g = got[k].double().numpy()
        w = np.asarray(v, np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _grads(step):
    return {k: torch.from_numpy(v) for k, v in _arrays(10 + step).items()}


@pytest.mark.parametrize('chain', list(CHAINS))
def test_plain_pass_matches_eager_chain_and_optax(chain):
    """Four steps: the plain pass equals the eager chain, and both equal
    optax's chain, its update and the JAX EMA, to 1e-6 relative."""
    tr, e_decay = CHAINS[chain]
    tx = TS.build_optimizer(tr)
    fused, eager = _state(tx, e_decay), _state(tx, e_decay)
    jtx = JS.build_optimizer(tr)
    jp = {k: jnp.asarray(v) for k, v in _arrays(0).items()}
    js, je = jtx.init(jp), dict(jp)
    loss = torch.tensor(0.5)
    for step in range(4):
        g = _grads(step)
        ok, bad = FU.reference(tx.options, e_decay, loss, g, fused)
        assert (bool(ok), bool(bad)) == (True, False)
        assert _eager(tx, eager, loss, g, e_decay) == (True, False)
        _close(_leaves(fused), {k: v.numpy()
                                for k, v in _leaves(eager).items()})
        ju, js = jtx.update({k: jnp.asarray(v.numpy()) for k, v in g.items()},
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        if e_decay > 0:
            je = JST.ema_update(je, jp, e_decay)
    _close({k: v for k, v in fused.params.items()}, jp)
    if e_decay > 0:
        _close(fused.ema_params, je)
    if tr['G_optimizer_type'] == JC.ADAM:
        adam = next(s for s in js if hasattr(s, 'mu'))
        for f in adam._fields[1:]:
            _close(fused.opt_state['adam'][f], getattr(adam, f))
        assert int(fused.opt_state['adam']['count']) == int(adam.count) == 4
    elif tr['G_optimizer_momentum'] > 0:
        trace = next(s for s in js if hasattr(s, 'trace'))
        _close(fused.opt_state['trace']['trace'], trace.trace)
    assert int(fused.opt_state['schedule']['count']) == 4


def test_prologue_matches_the_schedules():
    """The pass's learning rate from the count equals build_schedule's
    at every count across milestones, the step decay's floor and the
    warm-up."""
    for tr in (_train_cfg(G_scheduler_type=JC.MULTISTEPLR,
                          G_scheduler_milestones=[3, 7], G_scheduler_warmup=4),
               _train_cfg(G_scheduler_type=JC.MYSTEPLR,
                          G_scheduler_step_size=3, G_scheduler_min_lr=4e-5,
                          G_scheduler_warmup=4),
               _train_cfg()):
        h = FU.make_hyper(TS.chain_options(tr), 0.0)
        sched = TS.build_schedule(tr)
        for n in range(14):
            want = float(sched(torch.tensor(n, dtype=torch.int32)))
            np.testing.assert_allclose(float(FU.schedule_lr(h, n)), want,
                                       rtol=1e-6)


@pytest.mark.parametrize('where', ['nan_grad', 'inf_grad', 'nan_loss'])
@pytest.mark.parametrize('chain', ['adam_wd', 'amsgrad_clip_mystep_warmup'])
def test_nonfinite_step_is_skipped_exactly(chain, where):
    """A NaN or Inf in one grad leaf, or in the loss: ok is False, the
    parameters stay exactly, the moments take the zero grads (decayed,
    plus the decay term), the counts advance; as the eager chain."""
    tr, e_decay = CHAINS[chain]
    tx = TS.build_optimizer(tr)
    fused, eager = _state(tx, e_decay), _state(tx, e_decay)
    for state in (fused, eager):
        for step in range(2):
            FU.reference(tx.options, e_decay, torch.tensor(0.5),
                         _grads(step), state)
    p0 = {k: v.clone() for k, v in fused.params.items()}
    mu0 = {k: v.clone() for k, v in fused.opt_state['adam']['mu'].items()}
    g = _grads(5)
    loss = torch.tensor(0.5)
    if where == 'nan_loss':
        loss = torch.tensor(float('nan'))
    else:
        g['w'][2, 3] = float('nan') if where == 'nan_grad' else float('inf')
    ok, bad = FU.reference(tx.options, e_decay, loss, g, fused)
    assert (bool(ok), bool(bad)) == (False, False)
    assert _eager(tx, eager, loss, g, e_decay) == (False, False)
    for k in p0:
        assert torch.equal(fused.params[k], p0[k])
        assert not torch.equal(fused.opt_state['adam']['mu'][k], mu0[k])
    assert int(fused.opt_state['adam']['count']) == 3
    assert int(fused.opt_state['schedule']['count']) == 3
    _close(_leaves(fused), {k: v.numpy() for k, v in _leaves(eager).items()})


@pytest.mark.parametrize('chain', ['adam_wd', 'sgd_nesterov'])
def test_nonfinite_new_parameter_sets_corrupt(chain):
    tr, e_decay = CHAINS[chain]
    tx = TS.build_optimizer(tr)
    fused, eager = _state(tx, e_decay), _state(tx, e_decay)
    for state in (fused, eager):
        state.params['g'][1, 0, 1] = float('inf')
    loss = torch.tensor(0.5)
    ok, bad = FU.reference(tx.options, e_decay, loss, _grads(0), fused)
    assert (bool(ok), bool(bad)) == (True, True)
    assert _eager(tx, eager, loss, _grads(0), e_decay) == (True, True)


class _Card:
    """CPU tensors standing in for tensors on card 0, for the path rule
    alone: `get_device` reads 0 and the check launch is recorded, not
    run."""

    def __init__(self, monkeypatch):
        self.checks = 0
        monkeypatch.setattr(torch.Tensor, 'get_device', lambda t: 0)
        monkeypatch.setattr(FU.FusedUpdate, '_check',
                            lambda fu, loss, counts: self._count())

    def _count(self):
        self.checks += 1


@pytest.mark.parametrize('case', ['cpu', 'f32', 'bf16_grad', 'f64_param',
                                  'strided_grad', 'strided_param',
                                  'missing_grad', 'bf16_moment',
                                  'bf16_loss'])
def test_path_rule(monkeypatch, case):
    """On the CPU `begin` launches nothing and the step runs the eager
    chain. On the card the pass takes f32 tensors, the parameters and
    states contiguous (a strided grad is copied, a bf16 loss cast), and
    raises for anything else: the card never runs the eager chain."""
    tx = TS.build_optimizer(CHAINS['adam_wd'][0])
    state = _state(tx, 0.0)
    grads, loss = _grads(0), torch.tensor(0.5)
    fu = FU.FusedUpdate(tx.options)
    if case == 'cpu':
        assert fu.begin(loss, grads, state) is None
        return
    card = _Card(monkeypatch)
    if case == 'bf16_grad':
        grads['b'] = grads['b'].bfloat16()
    elif case == 'f64_param':
        state.params['g'] = state.params['g'].double()
    elif case == 'strided_grad':
        grads['w'] = grads['w'].t().contiguous().t()
    elif case == 'strided_param':
        state.params['w'] = state.params['w'].t().contiguous().t()
    elif case == 'missing_grad':
        del grads['g']
    elif case == 'bf16_moment':
        state.opt_state['adam']['nu']['w'] = \
            state.opt_state['adam']['nu']['w'].bfloat16()
    elif case == 'bf16_loss':
        loss = loss.bfloat16()
    if case not in ('f32', 'strided_grad', 'bf16_loss'):
        with pytest.raises(ValueError, match='fused update on the card'):
            fu.begin(loss, grads, state)
        assert card.checks == 0
        return
    run = fu.begin(loss, grads, state)
    assert run is not None and card.checks == 1
    # pointers in table order: grad, param, mu, nu; a strided grad
    # through its contiguous copy
    tab = fu._tabs[0]
    names = list(state.params)
    cols = [{k: g for k, g in zip(names, fu._grads)}, state.params,
            state.opt_state['adam']['mu'], state.opt_state['adam']['nu']]
    for depth, col in enumerate(cols):
        assert list(tab['ptr'][depth, :len(names)]) == \
            [col[k].data_ptr() for k in names]
    assert not tab['ptr'][4:].any()
    for k, g in zip(names, fu._grads):
        assert g.is_contiguous() and torch.equal(g, grads[k])
        assert (g is grads[k]) == (case != 'strided_grad' or k != 'w')


@pytest.mark.parametrize('where', ['cpu', 'card'])
def test_many_milestones(monkeypatch, where):
    """More milestones than the pass's constants hold: the CPU runs the
    eager chain, and the card refuses the step with a clear error."""
    tr = _train_cfg(G_scheduler_type=JC.MULTISTEPLR,
                    G_scheduler_milestones=list(
                        range(1, FU.MAX_MILESTONES + 2)))
    tx = TS.build_optimizer(tr)
    state = _state(tx, 0.0)
    fu = FU.FusedUpdate(tx.options)
    if where == 'cpu':
        assert fu.begin(torch.tensor(0.5), _grads(0), state) is None
        return
    card = _Card(monkeypatch)
    with pytest.raises(ValueError, match='milestones'):
        fu.begin(torch.tensor(0.5), _grads(0), state)
    assert card.checks == 0


def test_path_rule_takes_a_swinir_step(monkeypatch):
    """A small SwinIR's own loss and grads (the convolutions' weight
    grads come back channels-last) pass the rule."""
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.swinir import SwinIR
    torch.manual_seed(0)
    model = SwinIR(in_chans=1, mlp_ratio=2.0, device='cpu', upscale=2,
                   window_size=4, embed_dim=16, depths=(2,), num_heads=(2,),
                   upsampler='pixelshuffledirect').train()
    args = get_config()
    args.update(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=19,
                scale=2, h_size=16, n_channels=1)
    tx = TS.build_optimizer(args['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    cfg = P.PipeConfig(scale=2, h_size=16)
    gen = torch.Generator().manual_seed(0)
    hr = torch.randint(0, 256, (2, 32, 32, 1), generator=gen,
                       dtype=torch.uint8)
    lr = torch.randint(0, 256, (2, 16, 16, 1), generator=gen,
                       dtype=torch.uint8)
    batch = P.assemble(hr, lr, torch.tensor([0, 1]),
                       P.draw(gen, 2, cfg, (32, 32)), cfg, None)
    loss, _, _, grads = TSTEPS.loss_and_grads(
        model, build_loss(args), 'SwinIR', state.params, batch,
        torch.tensor(0), state.elb_t)
    assert not all(g.is_contiguous() for g in grads.values())
    card = _Card(monkeypatch)
    assert FU.FusedUpdate(tx.options).begin(loss, grads, state) is not None
    assert card.checks == 1


@pytest.mark.parametrize('numels,limits', [
    ((1, 7, 16384, 16385, 10 ** 6, 0, 3, 180), {}),
    ((1, 7, 16384, 16385, 10 ** 6, 0, 3, 180),
     dict(chunk=1000, max_leaves=3, max_chunks=5)),
    (tuple(np.random.default_rng(3).integers(1, 2 * 10 ** 5, 400)),
     dict(max_leaves=40)),
    ((5,) * 1000, dict(max_leaves=320, max_chunks=1280))])
def test_plan_covers_every_element_once(numels, limits):
    chunk = limits.get('chunk', FU.CHUNK)
    launches = FU.plan(numels, **limits)
    seen = [np.zeros(n, np.int32) for n in numels]
    block0 = 0
    for la in launches:
        assert la.block0 == block0
        assert 0 < len(la.chunk_leaf) <= limits.get('max_chunks',
                                                    FU.MAX_CHUNKS)
        assert len(la.leaves) <= limits.get('max_leaves', FU.MAX_LEAVES)
        for j, c in zip(la.chunk_leaf, la.chunk_idx):
            leaf = la.leaves[j]
            start = int(c) * chunk
            assert start < numels[leaf]
            seen[leaf][start:start + chunk] += 1
        block0 += len(la.chunk_leaf)
    assert all((s == 1).all() for s in seen)
    tabs = FU._tables(launches, numels)
    assert [int(t['n_chunks']) for t in tabs] == \
        [len(la.chunk_leaf) for la in launches]


def test_kernel_parameters_fit():
    """The table, the constants and the check's arguments are passed by
    value: within the 32,764 bytes of kernel parameters (CUDA >= 12.1)."""
    assert FU.TABLE.itemsize + ctypes.sizeof(FU.Hyper) + 8 * 8 <= 32764
    assert FU.TABLE.itemsize % 8 == 0
