"""The port's data-parallel train step (parallel/mesh.py,
train/steps.py:make_train_step(grid=)) on two gloo ranks on the CPU,
against the port's one-process step over the same global batch and
against the JAX step on a data=2 mesh of the 8 CPU devices
(tests/conftest.py), as tests/test_parallel.py:27 holds JAX's mesh step
to its one-device step.

The same params (bridge.flax_to_torch), fresh Adam states and the same
draws (JAX's, injected as in tests/test_torch_train_step.py). Held: the
params after the step within 1e-5 relative L2 (over all params); the
Adam moments within 1e-5 relative L2 of the one-process step's (the
gradient all-reduce) and of JAX's; the holder within 1e-5; both ranks
alike. The JAX side of the ReLU nets runs in float64, as
tests/test_torch_zoo_train.py explains. Against JAX the params are held
where JAX's grad is above 1e-4 of its tensor's largest (as
tests/test_torch_zoo2_train.py's `live`): Adam's first step moves a
param by +-lr whatever the size of its grad, so a grad within rounding
of 0 lands on either side (two elements of the options case's conv
weights, at 3e-5 of their tensors' largest grads, which hist's
sigmoids make large; the port's one-process step differs from JAX
there alike). The moments, unmasked, hold the grads: within 1e-5 of
JAX's, but in the options case within 2e-4 (hist's sigmoids, sigma
1e5, magnify f32 rounding: the port's one-process moments lie 1.1e-4
from JAX's too, and tests/test_torch_options_train.py holds hist to
1e-4). SwinIR's qkv_bias k third, whose grad is rounding noise, is
left out against both (`_signal`).
"""
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
from srcaco2_tpu.models import nlsn as JN
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.parallel.mesh import data_sharded, replicated
from srcaco2_tpu.parallel.mesh import make_mesh as j_make_mesh
from srcaco2_tpu.train import schedule as JSCH
from srcaco2_tpu.train import steps as JST
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.models import cnn_pre as TCP
from srcaco2_tpu_torch.models import nlsn as TN
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.parallel import mesh
from srcaco2_tpu_torch.utils import reproducibility as R

from test_torch_local_augs import jax_batch_draws
from test_torch_options_train import OPTIONS, TERMS, _stacks
from test_torch_train_parts import jax_draws
from test_torch_train_step import _signal
from test_torch_zoo2 import _Recorder
from torch_ddp_worker import run_step, spawn, step_rank

REL_L2 = 1e-5
B, HS, SCALE = 4, 16, 2
_SWIN = dict(upscale=2, window_size=4, embed_dim=16, depths=(2, 2),
             num_heads=(2, 2), upsampler='pixelshuffledirect', in_chans=1,
             mlp_ratio=2.0)
_MEM = dict(in_chans=1, upscale=2, num_memory_blocks=2,
            num_residual_blocks=2, features=8)
_NLSN = dict(in_chans=1, upscale=2, n_resblocks=8, n_feats=16, n_hashes=2,
             chunk_size=16)


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, drop_noise=False):
    return torch.cat([torch.as_tensor(_signal(k, v.detach().numpy())
                                      if drop_noise else v).reshape(-1)
                      .double() for k, v in sorted(tree.items())])


def rel_l2(a, b, drop_noise=False, live=None):
    """Relative L2 distance of a from b over all their tensors (those
    elements where `live`, a tree of the same shapes, is non-zero)."""
    a, b = _flat(a, drop_noise), _flat(b, drop_noise)
    if live is not None:
        keep = _flat(live, drop_noise) != 0
        a, b = a[keep], b[keep]
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _live(mu, share=1e-4):
    """Where a grad (read from Adam's first moment) is above `share` of
    its tensor's largest."""
    return {k: (v.abs() > share * v.abs().max()).double()
            for k, v in mu.items()}


def _jax_mu(js, tm):
    adam = next(s for s in js.opt_state if hasattr(s, 'mu'))
    return flax_to_torch(adam.mu, tm)


def _flags(**kw):
    f = dict(scale=SCALE, h_size=HS, n_channels=1, **kw)
    return {**j_get_config(), **f}, {**t_get_config(), **f}


def _data(n_img=4, seed=4):
    r = np.random.default_rng(seed)
    hr = r.integers(0, 256, (n_img, 2 * HS, 2 * HS, 1), dtype=np.uint8)
    lr = r.integers(0, 256, (n_img, 2 * HS // SCALE, 2 * HS // SCALE, 1),
                    dtype=np.uint8)
    return hr, lr


def _jax_mesh_step(jm, pn, ja, nt, cfg, hr, lr, idxs, key, ms=None,
                   ppiw=None):
    """JAX's step on a data=2 mesh: (state after, holder, ok)."""
    m = j_make_mesh(data=2)
    rep = replicated(m)
    tx = JSCH.build_optimizer(ja['train'])
    st = jax.device_put(JTrainState.create(pn, tx, model_state=ms), rep)
    step = JST.make_train_step(
        jm, j_build_loss(ja), tx, nt, cfg, steps_per_epoch=1000, mesh=m,
        ppiw_table=None if ppiw is None else jnp.asarray(ppiw))
    return step(st, jax.device_put(jnp.asarray(hr), rep),
                jax.device_put(jnp.asarray(lr), rep),
                jax.device_put(jnp.asarray(idxs), data_sharded(m)), key)


def _init(jm, x, x64):
    v = jax.jit(lambda k, t: jm.init(k, t, train=False))(jax.random.key(0),
                                                          x)
    return jax.tree.map(np.asarray, v)


def _case_cnn(jcls, tcls, kw, nt, **flags):
    """A ReLU net (JAX in float64) on JAX's uniform draws."""
    def build(monkeypatch):
        ja, ta = _flags(**flags)
        hr, lr = _data()
        idxs = np.array([3, 0, 1, 2], np.int32)
        key = jax.random.key(5)
        cfg = JP.PipeConfig(scale=SCALE, h_size=HS)
        tcfg = TP.PipeConfig(scale=SCALE, h_size=HS)
        rots = None
        tm = tcls(device='cpu', **kw)
        if tcls is TN.NLSN:
            shape = tm.NonLocalSparseAttention_0.rotation_shape(
                (HS // SCALE) ** 2)
            rng = np.random.default_rng(9)
            rots = [rng.standard_normal(shape).astype(np.float32)
                    for _ in range(kw['n_resblocks'] // 8 + 1)]
            _Recorder(monkeypatch, inject=rots)
        with jax.enable_x64(True):
            jm = jcls(dtype=jnp.float64, **kw)
            jb = JP.make_train_batch(jnp.asarray(hr), jnp.asarray(lr),
                                     jnp.asarray(idxs),
                                     jax.random.fold_in(key, 0), cfg)
            v = _init(jm, JST.net_input(nt, jb), True)
            pn = v['params']
            ms = {k: a for k, a in v.items() if k != 'params'} or None
            js, jh, jok = _jax_mesh_step(jm, pn, ja, nt, cfg, hr, lr, idxs,
                                         key, ms)
            js = jax.tree.map(np.asarray, js)
            draws = jax_draws(jax.random.fold_in(key, 0), B, 2 * HS, HS)
        payload = dict(cls=tcls, kw=kw, net_type=nt, args=ta, cfg=tcfg,
                       state=flax_to_torch(pn, tm, model_state=ms),
                       hr=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                       idxs=torch.from_numpy(idxs), draws=draws,
                       rotations=rots)
        jres = dict(params=flax_to_torch(js.params, tm), ok=bool(jok),
                    total=float(jh['total']), mu=_jax_mu(js, tm),
                    buffers=None if ms is None else
                    {k: v for k, v in flax_to_torch(
                        js.params, tm, model_state=js.model_state).items()
                     if k not in dict(tm.named_parameters())})
        return payload, jres, False
    return build


def _case_swinir(opts=False, **flags):
    """The small fused SwinIR (the plain K1 / K2 on the CPU; JAX's
    fused_mode='never'), f32 on both sides; with `opts`, every option of
    chip_smoke.py's entry_opts (the sampling, the local augs, ppiw and
    the loss terms) on JAX's draws."""
    def build(monkeypatch):
        ja, ta = _flags(**flags)
        cfg_kw = dict(scale=SCALE, h_size=HS, **(OPTIONS if opts else {}))
        cfg, tcfg = JP.PipeConfig(**cfg_kw), TP.PipeConfig(**cfg_kw)
        hr, lr = _stacks() if opts else _data()
        ppiw = JP.per_color_weights(hr, 0.001) if opts else None
        idxs = np.array([5, 0, 2, 3], np.int32) if opts else \
            np.array([3, 0, 1, 2], np.int32)
        key = jax.random.key(4)
        jm = JSwinIR(fused_blocks=True, fused_mode='never', **_SWIN)
        pn = _init(jm, jnp.zeros((1, 1, 8, 8)), False)['params']
        js, jh, jok = _jax_mesh_step(jm, pn, ja, JC.SWINIR, cfg, hr, lr,
                                     idxs, key, ppiw=ppiw)
        js = jax.tree.map(np.asarray, js)
        if opts:
            draws = jax_batch_draws(jax.random.fold_in(key, 0), hr, lr,
                                    idxs, cfg)
        else:
            draws = jax_draws(jax.random.fold_in(key, 0), B, 2 * HS, HS)
        tm = TSwinIR(device='cpu', **_SWIN)
        payload = dict(cls=TSwinIR, kw=_SWIN, net_type=JC.SWINIR, args=ta,
                       cfg=tcfg, state=flax_to_torch(pn, tm),
                       hr=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                       idxs=torch.from_numpy(idxs), draws=draws,
                       ppiw=None if ppiw is None else torch.from_numpy(ppiw))
        jres = dict(params=flax_to_torch(js.params, tm), ok=bool(jok),
                    total=float(jh['total']), mu=_jax_mu(js, tm),
                    buffers=None)
        return payload, jres, True
    return build


CASES = {
    'srcnn_l2': _case_cnn(JCP.SRCNN, TCP.SRCNN, dict(in_chans=1),
                          JC.SRCNN, l2=True),
    'srcnn_l2sum': _case_cnn(JCP.SRCNN, TCP.SRCNN, dict(in_chans=1),
                             JC.SRCNN, l2sum=True),
    'memnet': _case_cnn(JCP.MemNet, TCP.MemNet, _MEM, JC.MEMNET, l2=True,
                        ssim=True, ssim_window_s=7),
    'nlsn': _case_cnn(JN.NLSN, TN.NLSN, _NLSN, JC.NLSN, l2=True),
    'swinir': _case_swinir(l2=True, ssim=True, ssim_window_s=7),
    'options': _case_swinir(opts=True, **TERMS, **OPTIONS),
}


def _same_on_both_ranks(a, b):
    for part in ('params', 'mu', 'nu', 'buffers', 'holder'):
        for k in a[part]:
            torch.testing.assert_close(a[part][k], b[part][k], rtol=0,
                                       atol=0, equal_nan=True,
                                       msg=f'{part} {k}')
    assert a['ok'] == b['ok']


@pytest.mark.parametrize('case', sorted(CASES))
def test_two_ranks_match_one_process_and_jax(case, tmp_path, monkeypatch):
    payload, jres, swin = CASES[case](monkeypatch)
    codes, res, _ = spawn(step_rank, 2, tmp_path, payload)
    assert codes == [0, 0], codes
    r0, r1 = res
    _same_on_both_ranks(r0, r1)
    one = run_step(payload)
    assert r0['ok'] and one['ok'] and jres['ok']
    assert rel_l2(r0['params'], one['params'], swin) <= REL_L2
    assert rel_l2(r0['params'], jres['params'], swin,
                  _live(jres['mu'])) <= REL_L2
    assert rel_l2(r0['mu'], one['mu'], swin) <= REL_L2
    assert rel_l2(r0['mu'], jres['mu'], swin) <= \
        (2e-4 if case == 'options' else REL_L2)
    for k in one['holder']:
        np.testing.assert_allclose(float(r0['holder'][k]),
                                   float(one['holder'][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(r0['holder']['total']), jres['total'],
                               rtol=1e-5)
    if jres['buffers']:
        # MemNet's running statistics: the global batch's, on both ranks
        moved = 0
        for k, b in r0['buffers'].items():
            np.testing.assert_allclose(b.numpy(), one['buffers'][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(b.numpy(), jres['buffers'][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            moved += not torch.equal(b, payload['state'][k])
        assert moved == len(r0['buffers'])


def _srcnn_payload(gaus=False, k=1):
    _, ta = _flags(l2=True)
    cfg = TP.PipeConfig(scale=SCALE, h_size=HS, da_add_gaus_noise=gaus,
                        da_add_gaus_noise_prob=1.0)
    hr, lr = _data(n_img=6, seed=7)
    tm = TCP.SRCNN(device='cpu', in_chans=1)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    idxs = torch.randint(0, 6, (k, B), generator=g)
    draws = [TP.draw(R.step_generator(3, j, 'cpu'), B, cfg, (2 * HS, 2 * HS))
             for j in range(k)]
    return dict(cls=TCP.SRCNN, kw=dict(in_chans=1), net_type=JC.SRCNN,
                args=ta, cfg=cfg, state=tm.state_dict(),
                hr=torch.from_numpy(hr), lr=torch.from_numpy(lr),
                idxs=idxs if k > 1 else idxs[0],
                draws=draws if k > 1 else draws[0])


def test_mesh_model_2_equals_one_process(tmp_path):
    """A grid of 1 data shard x 2 replicas: both ranks take the whole
    batch, and the average of the two equal grads is the one-process
    grad."""
    payload = dict(_srcnn_payload(), mesh_model=2)
    codes, (r0, r1), _ = spawn(step_rank, 2, tmp_path, payload)
    assert codes == [0, 0]
    _same_on_both_ranks(r0, r1)
    one = run_step(payload)
    assert rel_l2(r0['params'], one['params']) <= REL_L2
    assert rel_l2(r0['mu'], one['mu']) <= REL_L2


def test_nan_on_one_shard_skips_on_every_rank(tmp_path):
    """A NaN in rank 1's shard only (its first sample's noise field):
    the all-reduced grads and loss are NaN on both ranks, so both skip:
    the params stay, the flags say skipped, and the ranks agree."""
    payload = dict(_srcnn_payload(gaus=True), nan_rank=1)
    codes, (r0, r1), _ = spawn(step_rank, 2, tmp_path, payload)
    assert codes == [0, 0]
    _same_on_both_ranks(r0, r1)
    assert not r0['ok'] and not r1['ok']
    assert float(r0['holder']['_skipped']) == 1.0
    assert float(r0['holder']['_corrupt']) == 1.0   # the NaN prediction
    for k, v in r0['params'].items():
        assert torch.equal(v, payload['state'][k]), k
    assert r0['step'] == 1


def test_superstep_under_two_ranks(tmp_path):
    """JAX's test_superstep_under_mesh_matches_per_step: K=2 updates in
    one call under 2 ranks equal two calls of one step under 2 ranks bit
    for bit (one all-reduce per update), and the one-process steps
    within 1e-5."""
    payload = _srcnn_payload(k=2)
    sup = tmp_path / 'sup'
    sup.mkdir()
    codes, (s0, s1), _ = spawn(step_rank, 2, sup,
                               dict(payload, superstep=True))
    assert codes == [0, 0]
    codes, (p0, _), _ = spawn(step_rank, 2, tmp_path, payload)
    assert codes == [0, 0]
    _same_on_both_ranks(s0, s1)
    for part in ('params', 'mu', 'nu', 'holder'):
        for k in s0[part]:
            assert torch.equal(s0[part][k], p0[part][k]), (part, k)
    assert s0['step'] == 2
    one = run_step(payload)
    assert rel_l2(s0['params'], one['params']) <= REL_L2


def test_nlsn_ranks_draw_the_same_rotations(tmp_path):
    """NLSN's rotations are (1, c, hashes, buckets): no batch axis, so
    every rank draws the whole of them from the step's lsh generator;
    the 2-rank step equals the one-process step with the same
    generator."""
    _, ta = _flags(l2=True)
    tm = TN.NLSN(device='cpu', **_NLSN)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    hr, lr = _data()
    cfg = TP.PipeConfig(scale=SCALE, h_size=HS)
    payload = dict(cls=TN.NLSN, kw=_NLSN, net_type=JC.NLSN, args=ta,
                   cfg=cfg, state=tm.state_dict(), hr=torch.from_numpy(hr),
                   lr=torch.from_numpy(lr), idxs=torch.tensor([3, 0, 1, 2]),
                   draws=TP.draw(R.step_generator(1, 0, 'cpu'), B, cfg,
                                 (2 * HS, 2 * HS)), lsh_seed=11)
    codes, (r0, r1), _ = spawn(step_rank, 2, tmp_path, payload)
    assert codes == [0, 0]
    _same_on_both_ranks(r0, r1)
    one = run_step(payload)
    assert r0['ok'] and one['ok']
    assert rel_l2(r0['params'], one['params']) <= REL_L2
    assert rel_l2(r0['mu'], one['mu']) <= REL_L2


# ------------------------------------------------------------- the grid

def test_grid_rows_and_sizes():
    g = mesh.make_mesh(data=2, model=2, rank=3, world=4)
    assert (g.shard, g.world, g.shape) == (1, 4, {'data': 2, 'model': 2})
    assert g.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match='not divisible'):
        g.rows(7)
    with pytest.raises(ValueError, match='world size 4'):
        mesh.make_mesh(data=3, model=1, rank=0, world=4)
    g = mesh.make_mesh({'mesh_data': -1, 'mesh_model': 2}, rank=0, world=4)
    assert (g.data, g.model) == (2, 2)
    assert mesh.make_mesh(rank=0, world=1) == mesh.Grid(1, 1, 0)


@pytest.mark.parametrize('env,want', [
    ({}, (0, 1, 0)),
    ({'RANK': '3', 'WORLD_SIZE': '4', 'LOCAL_RANK': '1'}, (3, 4, 1)),
    ({'SLURM_PROCID': '2', 'SLURM_NTASKS': '8', 'SLURM_LOCALID': '2'},
     (2, 8, 2)),
    ({'RANK': '1', 'WORLD_SIZE': '2', 'SLURM_PROCID': '5',
      'SLURM_NTASKS': '8'}, (1, 2, 0)),
    ({'RANK': '1'}, RuntimeError),
    ({'SLURM_PROCID': '1'}, RuntimeError),
])
def test_launcher_world(env, want):
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match='not'):
            mesh.launcher_world(env)
    else:
        assert mesh.launcher_world(env) == want


def test_shard_draws_takes_the_rows_of_every_choice():
    cfg = TP.PipeConfig(scale=2, h_size=16, da_blur=True,
                        da_dot_bin_noise=True, da_add_gaus_noise=True)
    d = TP.draw(torch.Generator().manual_seed(0), 6, cfg, (32, 32))
    d = d._replace(lsh=R.lsh_generator(0, 0))
    s = mesh.shard_draws(d, slice(2, 4))
    assert torch.equal(s.x0, d.x0[2:4]) and torch.equal(s.mode, d.mode[2:4])
    for a, b in ((s.blur, d.blur), (s.dot, d.dot), (s.gaus, d.gaus)):
        for fa, fb in zip(a, b):
            assert torch.equal(fa, fb[2:4])
    assert s.lsh is d.lsh
