"""On the card: the train step's fused pass (csrc/fused_update.cu) against
the eager chain, the step's host syncs and its counter. Each test skips
where no card is visible. Imports no JAX, so that it runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider -m chip \\
        tests/test_torch_fused_update_chip.py
"""
import importlib.util
import warnings
from pathlib import Path

import pytest
import torch

from srcaco2_tpu_torch import constants as C
from srcaco2_tpu_torch.config.defaults import get_config
from srcaco2_tpu_torch.ops import fused_update as FU
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train import steps as TSTEPS
from srcaco2_tpu_torch.train.state import TrainState, all_finite
from srcaco2_tpu_torch.utils import profiling

STEPS, NAN_STEP = 5, 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    return torch.device('cuda', 0)


def _train(**kw):
    tr = dict(get_config(C.SWINIR)['train'])
    tr.update(kw)
    return tr


# (train config, EMA decay)
CHAINS = {
    'adam_wd_ema': (_train(G_optimizer_wd=1e-4), 0.999),
    'amsgrad_clip_mystep_warmup': (_train(
        G_optimizer_amsgrad=True, G_optimizer_clipgrad=0.5,
        G_scheduler_type=C.MYSTEPLR, G_scheduler_step_size=2,
        G_scheduler_min_lr=1e-5, G_scheduler_warmup=3), 0.0),
    'sgd_nesterov_multistep': (_train(
        G_optimizer_type=C.SGD, G_optimizer_momentum=0.9,
        G_optimizer_nesterov=True, G_optimizer_wd=1e-4,
        G_scheduler_milestones=[1, 3], G_scheduler_warmup=2), 0.0),
}


@pytest.fixture(scope='module')
def nets(card):
    """The parameters of SwinIR x8 (the flagship), and of DFCAN, OmniSR
    and DBPN x8: OmniSR's 1,066 leaves and DBPN's 1,524 chunks split the
    leaf table over launches (4 and 2)."""
    from srcaco2_tpu_torch.models.registry import define_g
    cs = _chip_smoke()
    out = {}
    for name, args in (('swinir', cs.flagship_args()),
                       ('dfcan', cs.zoo_args('DFCAN', True)),
                       ('omnisr', cs.zoo_args('OmniSR', True)),
                       ('dbpn', cs.zoo_args('DBPN', True))):
        model = define_g(args, card, seed=0)
        out[name] = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
        del model
    return out


def _grads(params, step, layout):
    """Seeded grads of the parameters' shapes: each its own tensor
    ('own'), views of one flat buffer (the data-parallel all-reduce's
    layout, 'flat'), or the 4-d ones channels-last (as autograd returns
    a convolution's weight grad, 'channels_last'); NaN in one leaf at
    NAN_STEP."""
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(100 + step)
    total = sum(p.numel() for p in params.values())
    buf = torch.randn(total, generator=gen, device=dev) * 1e-2
    out, off = {}, 0
    for k, p in params.items():
        g = buf[off:off + p.numel()].view(p.shape)
        if layout == 'channels_last' and g.dim() == 4:
            g = g.contiguous(memory_format=torch.channels_last)
        out[k] = g if layout == 'flat' else g.clone()
        off += p.numel()
    if step == NAN_STEP:
        first = next(iter(out.values()))
        first[(0,) * first.dim()] = float('nan')
    return out


def _leaves(state):
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


@pytest.mark.chip
@pytest.mark.parametrize('layout', ['own', 'flat', 'channels_last'])
@pytest.mark.parametrize('chain', list(CHAINS))
@pytest.mark.parametrize('net', ['swinir', 'dfcan', 'omnisr', 'dbpn'])
def test_fused_pass_equals_eager_chain(card, nets, net, chain, layout,
                                       monkeypatch):
    """Five steps, one of them skipped for a NaN grad: the parameters,
    the moments (AMSGrad's max, the SGD trace), the EMA, the counts and
    the ok / corrupt flags equal the eager chain's bit for bit; with
    clipping, the global norm (summed in another order) within 1e-6 of
    the eager chain's, which then clips by the pass's norm. OmniSR and
    DBPN take more than one launch."""
    fu = _equal_over_steps(card, nets[net], chain, layout, monkeypatch)
    assert (len(fu._tabs) > 1) == (net in ('omnisr', 'dbpn'))


@pytest.mark.chip
@pytest.mark.parametrize('chain', ['adam_wd_ema',
                                   'amsgrad_clip_mystep_warmup'])
def test_split_table_equals_eager_chain(card, nets, chain, monkeypatch):
    """The leaf table split over many launches (at most 7 leaves and 50
    chunks each, leaves spanning launches): the same as in one."""
    plan = FU.plan
    monkeypatch.setattr(FU, 'plan', lambda numels: plan(
        numels, max_leaves=7, max_chunks=50))
    fu = _equal_over_steps(card, nets['swinir'], chain, 'own', monkeypatch)
    assert len(fu._tabs) > 10


@pytest.mark.chip
def test_nonfinite_parameter_sets_corrupt(card, nets):
    """An Inf parameter: the step is taken (finite grads), and the
    corrupt flag is set, as the eager chain's check sets it."""
    tr, e_decay = CHAINS['adam_wd_ema']
    tx = TS.build_optimizer(tr)
    params = {k: v.clone() for k, v in nets['dfcan'].items()}
    last = list(params.values())[-1]
    last[(0,) * last.dim()] = float('inf')
    state = TrainState.create(params, tx, e_decay=e_decay)
    fu = FU.FusedUpdate(tx.options, e_decay)
    flags = fu.begin(torch.full((), 0.5, device=card),
                     _grads(params, 0, 'own'), state)
    fu.apply()
    assert bool(flags[0]) and bool(flags[1])
    assert bool(~all_finite(state.params))


def _pass_global_norm(fu):
    """The global norm the last check launch computed (csrc Header's
    float word 4; 0 without clipping or on a skipped step)."""
    return fu._scratch[4:5].view(torch.float32).reshape(()).clone()


def _equal_over_steps(card, base, chain, layout, monkeypatch):
    """`STEPS` steps of the pass and of the eager chain from the same
    state; the eager chain clips by the pass's global norm, which must
    be within 1e-6 of its own (the one difference the pass allows: its
    order of summation). Everything else bit for bit."""
    tr, e_decay = CHAINS[chain]
    tx = TS.build_optimizer(tr)
    eager = TrainState.create({k: v.clone() for k, v in base.items()}, tx,
                              e_decay=e_decay)
    fused = TrainState.create({k: v.clone() for k, v in base.items()}, tx,
                              e_decay=e_decay)
    fu = FU.FusedUpdate(tx.options, e_decay)
    loss = torch.full((), 0.5, device=card)
    launched = FU.launch_check.launches, FU.launch_update.launches
    for step in range(STEPS):
        grads = _grads(base, step, layout)
        flags = fu.begin(loss, grads, fused)
        assert flags is not None
        fu.apply()
        gnorm = _pass_global_norm(fu)
        ok = torch.isfinite(loss) & all_finite(grads)
        safe = {k: torch.where(ok, g, torch.zeros_like(g))
                for k, g in grads.items()}
        with monkeypatch.context() as m:
            if tr.get('G_optimizer_clipgrad', 0) > 0:
                own = float(TS.global_norm(safe))
                assert abs(float(gnorm) - own) <= 1e-6 * own, (
                    step, float(gnorm), own)
                m.setattr(TS, 'global_norm', lambda updates: gnorm)
            TSTEPS._eager_update(tx, eager, safe, ok, e_decay)
        corrupt = ~all_finite(eager.params)
        assert bool(flags[0]) == bool(ok) == (step != NAN_STEP)
        assert not bool(flags[1]) and not bool(corrupt)
        n = len(fu._tabs) * (step + 1)
        assert (FU.launch_check.launches - launched[0],
                FU.launch_update.launches - launched[1]) == (n, n)
        want, got = _leaves(eager), _leaves(fused)
        assert want.keys() == got.keys()
        for k, w in want.items():
            assert torch.equal(got[k], w), (step, k,
                                            (got[k] - w).abs().max())
    return fu


@pytest.fixture(scope='module')
def flagship(card):
    cs = _chip_smoke()
    ctx = cs.train_setup(card)
    ctx['inputs'] = lambda: cs.step_inputs(ctx['gen'], ctx['cfg'],
                                           cs.TRAIN_B)
    state, _, _ = ctx['step'](ctx['state'], ctx['hr'], ctx['lr'],
                              *ctx['inputs']())
    ctx['state'] = state
    torch.cuda.synchronize(card)
    return ctx


@pytest.mark.chip
def test_train_step_makes_no_host_sync(card, flagship):
    """One SwinIR x8 train step (after a warm-up step) under the sync
    debug mode: no warning."""
    ctx = flagship
    inputs = ctx['inputs']()
    torch.cuda.synchronize(card)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            ctx['state'], _, _ = ctx['step'](ctx['state'], ctx['hr'],
                                             ctx['lr'], *inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(card)
    # the mode's own notice that it is a prototype is no sync
    syncs = [str(w.message) for w in seen
             if 'synchroniz' in str(w.message)
             and 'prototype' not in str(w.message)]
    assert not syncs, syncs


@pytest.mark.chip
def test_update_fused_counts_each_step(card, flagship):
    """`train.update_fused` counts one per `train.step` while a profiler
    records."""
    ctx = flagship
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            ctx['state'], _, _ = ctx['step'](ctx['state'], ctx['hr'],
                                             ctx['lr'], *ctx['inputs']())
        torch.cuda.synchronize(card)
    steps = sum(1 for name, _, _ in profiling.records()
                if name == 'train.step')
    assert steps == 2
    assert profiling.counters().get('train.update_fused') == steps
