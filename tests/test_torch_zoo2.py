"""The zoo's second part (srcaco2_tpu_torch/models: NLSN, GRL, DRRN,
MemNet) against the JAX package's at small sizes, as tests/
test_torch_zoo.py holds the first: the same numpy-seeded inputs, JAX's
params (jitted init; MemNet's batch statistics replaced by seeded random
ones, so that evaluation normalises with something) carried by
bridge.flax_to_torch, the forward within 1e-5 of max|out| in f32 and
within BF16_TOL of it in bf16 (the JAX side compiled without excess
precision).

NLSN hashes with rotations recorded from an unjitted JAX apply (a
wrapper around jax.random.normal) and injected into the port; its sort
is stable on hash ties, as jnp.argsort is. GRL is held against JAX's
windowed path (SRCACO2_GRL_MERGED=0) within 1e-5 and against its
default merged-tile path within tests/test_grl_merged.py's tolerance.
MemNet's running statistics after one training forward are JAX's
mutable batch_stats, with its per-pass checkpoint on and off; the
checkpoint leaves outputs, grads and the statistics (moved once per
application) as they are, for MemNet and SRFBN."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.models import cnn_pre as JC
from srcaco2_tpu.models import grl as JG
from srcaco2_tpu.models import nlsn as JN
from srcaco2_tpu.models import srfbn as JS
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.models import blocks as TB
from srcaco2_tpu_torch.models import cnn_pre as TC
from srcaco2_tpu_torch.models import grl as TG
from srcaco2_tpu_torch.models import nlsn as TN
from srcaco2_tpu_torch.models import srfbn as TS

from test_torch_zoo import BF16_TOL, _outs


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_GRL = dict(in_chans=1, upscale=2, embed_dim=16, depths=(2, 1),
            num_heads_window=(2, 2), num_heads_stripe=(2, 2),
            window_size=4, stripe_size=(4, 4))
_MEM = dict(in_chans=1, upscale=2, num_memory_blocks=2,
            num_residual_blocks=2, features=8)

# name: (JAX class, port class, constructor kwargs, input NCHW shape).
# GRL's first stage (depth 2) is scanned in JAX, its second (depth 1)
# unrolled: the bridge maps both layouts.
NETS = {
    'DRRN': (JC.DRRN, TC.DRRN, dict(in_chans=1, upscale=2,
                                    num_residual_units=3, features=8),
             (2, 1, 8, 8)),
    'MemNet': (JC.MemNet, TC.MemNet, dict(**_MEM), (2, 1, 8, 8)),
    'MemNet_x4': (JC.MemNet, TC.MemNet, dict(_MEM, upscale=4,
                                             num_residual_blocks=3),
                  (1, 1, 6, 6)),
    # L = 64 over chunks of 16: 4 buckets, no padding
    'NLSN': (JN.NLSN, TN.NLSN, dict(in_chans=1, upscale=2, n_resblocks=8,
                                    n_feats=16, n_hashes=2, chunk_size=16),
             (2, 1, 8, 8)),
    # L = 81 over chunks of 12: 6 buckets, a wrap-around pad of 3
    'NLSN_padded': (JN.NLSN, TN.NLSN, dict(in_chans=1, upscale=2,
                                           n_resblocks=8, n_feats=16,
                                           n_hashes=3, chunk_size=12),
                    (1, 1, 9, 9)),
    'GRL': (JG.GRL, TG.GRL, _GRL, (2, 1, 8, 8)),
    # not a multiple of the window: the zero pad and the crop
    'GRL_padded': (JG.GRL, TG.GRL, _GRL, (1, 1, 10, 12)),
    # rectangular stripes: (8, 4) H stripes, (4, 8) W stripes
    'GRL_stripes': (JG.GRL, TG.GRL, dict(_GRL, stripe_size=(8, 4)),
                    (1, 1, 8, 16)),
}


def _random_stats(stats, seed=7):
    """batch_stats with seeded random means and positive variances."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == 'mean':
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, stats)


class _Recorder:
    """jax.random.normal wrapped: every draw of the rotation's shape is
    recorded (concrete, in an unjitted apply) or, with `inject`, replaced
    by the given arrays in call order, cyclically: each forward (an
    init's, a step's, each traced once under jit) takes one per layer."""

    def __init__(self, monkeypatch, inject=None):
        self.real = jax.random.normal
        self.drawn, self.inject = [], inject
        monkeypatch.setattr(jax.random, 'normal', self)

    def __call__(self, key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[0] == 1:
            if self.inject is not None:
                i = len(self.drawn) % len(self.inject)
                r = jnp.asarray(self.inject[i], dtype)
                self.drawn.append(r)
                return r
            r = self.real(key, shape, dtype)
            self.drawn.append(np.asarray(r))
            return r
        return self.real(key, shape, dtype)


def pair(name, dtype=jnp.float32, monkeypatch=None):
    """(JAX module, variables, port module with them, input)."""
    jcls, tcls, kw, shape = NETS[name]
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    jm = jcls(dtype=dtype, **kw)
    v = jax.tree.map(np.asarray, jax.jit(
        lambda k, t: jm.init(k, t, train=False))(jax.random.key(0),
                                                 jnp.asarray(x)))
    if 'batch_stats' in v:
        v = {**v, 'batch_stats': _random_stats(v['batch_stats'])}
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tm = tcls(dtype=tdt, device='cpu', **kw)
    ms = {k: a for k, a in v.items() if k != 'params'}
    tm.load_state_dict(flax_to_torch(v['params'], tm,
                                     model_state=ms or None))
    if tcls is TN.NLSN:
        rec = _Recorder(monkeypatch)
        jm.apply(v, jnp.asarray(x), train=False)
        monkeypatch.setattr(jax.random, 'normal', rec.real)
        tm.rotations = rec.drawn
        assert len(rec.drawn) == kw['n_resblocks'] // 8 + 1
    return jm, v, tm.eval(), x


def jax_forward(jm, v, x, exact=False):
    fn = jax.jit(lambda t: jm.apply(v, t, train=False))
    if exact:
        fn = fn.lower(jnp.asarray(x)).compile(
            compiler_options={'xla_allow_excess_precision': False})
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        fn(jnp.asarray(x)))


@pytest.fixture(autouse=True)
def _windowed_grl(monkeypatch):
    monkeypatch.setenv('SRCACO2_GRL_MERGED', '0')


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_f32_matches_jax(name, monkeypatch):
    jm, v, tm, x = pair(name, monkeypatch=monkeypatch)
    ref = _outs(jax_forward(jm, v, x))
    with torch.no_grad():
        got = _outs(tm(torch.from_numpy(x)))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= 1e-5 * np.abs(r).max() + 1e-7, (k, err)
        assert np.linalg.norm(g - r) <= 1e-5 * np.linalg.norm(r), k


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_bf16_matches_jax(name, monkeypatch):
    jm, v, tm, x = pair(name, jnp.bfloat16, monkeypatch)
    ref = _outs(jax_forward(jm, v, x, exact=True))
    with torch.no_grad():
        got = _outs(tm(torch.from_numpy(x)))
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        err = np.abs(g - r).max()
        assert err <= BF16_TOL * np.abs(r).max(), (k, err)


@pytest.mark.parametrize('hw', [8, 16])
def test_grl_against_the_merged_path(hw, monkeypatch):
    """The port's windowed GRL against JAX's default merged 2ws-tile path
    (window 4, stripes (4, 4), down factor 2: 8x8 tiles), one tile and
    four, within test_grl_merged.py's tolerance."""
    monkeypatch.setenv('SRCACO2_GRL_MERGED', '1')
    kw = dict(_GRL, depths=(2,), num_heads_window=(2,),
              num_heads_stripe=(2,))
    x = np.random.default_rng(3).uniform(0, 1, (2, 1, hw, hw)).astype(
        np.float32)
    jm = JG.GRL(**kw)
    pn = jax.tree.map(np.asarray, jax.jit(
        lambda k, t: jm.init(k, t)['params'])(jax.random.key(1),
                                              jnp.asarray(x)))
    pn = jax.tree.map(lambda a: a + 0.03 * np.random.default_rng(1)
                      .standard_normal(a.shape).astype(np.float32), pn)
    ref = np.asarray(jax.jit(lambda t: jm.apply({'params': pn}, t))(
        jnp.asarray(x))['out'])
    tm = TG.GRL(device='cpu', **kw)
    tm.load_state_dict(flax_to_torch(pn, tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))['out'].numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_grl_tables_match_jax():
    """The copied position tables and shift mask equal JAX's."""
    for ws, df in (((4, 4), 1), ((8, 8), 2), ((8, 4), 2)):
        np.testing.assert_array_equal(TG.coords_table(ws, df),
                                      JG.coords_table(ws, df))
        for w2a in (True, False):
            np.testing.assert_array_equal(TG.rel_index(ws, df, w2a),
                                          JG.rel_index(ws, df, w2a))
    np.testing.assert_array_equal(TG.shift_mask((16, 24), (8, 8), (4, 4)),
                                  JG.shift_mask((16, 24), (8, 8), (4, 4)))


def test_nlsn_sort_is_stable_on_ties():
    """Hash codes with many ties (a few buckets over 2^14 positions, the
    size where an unstable sort reorders equal keys): the port's order
    and its inverse equal jnp.argsort's (stable) and numpy's stable
    sort, and the inverse undoes the order."""
    codes = np.random.default_rng(5).integers(0, 6, (2, 1 << 14))
    idx, undo = TN.lsh_sort(torch.from_numpy(codes))
    ref = np.asarray(jnp.argsort(jnp.asarray(codes), axis=-1))
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(
        idx.numpy(), np.argsort(codes, axis=-1, kind='stable'))
    rows = np.arange(2)[:, None]
    np.testing.assert_array_equal(idx.numpy()[rows, undo.numpy()],
                                  np.broadcast_to(np.arange(1 << 14),
                                                  codes.shape))


def test_nlsn_forward_with_tied_embeddings(monkeypatch):
    """An input tiled from one 2x2 patch: interior positions of the same
    phase see equal 5x5 neighbourhoods through the two 3x3 convs, so
    their embeddings, and their hash codes in every round, are equal,
    and the chunks depend on how the sort orders ties; the port's
    forward equals JAX's within the f32 tolerance."""
    jm, v, tm, _ = pair('NLSN', monkeypatch=monkeypatch)
    tile = np.random.default_rng(4).uniform(0, 1, (2, 1, 2, 2)).astype(
        np.float32)
    x = np.tile(tile, (1, 1, 4, 4))
    ref = jax_forward(jm, v, x)['out']
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tm(xt)['out'].numpy()
        attn = tm.NonLocalSparseAttention_0
        emb = TB.to_nhwc(attn.conv_match(tm.head(xt))).reshape(2, 64, -1)
        codes = attn.hash_codes(emb, torch.from_numpy(
            np.array(tm.rotations[0])))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    c = codes.reshape(2, 2, 8, 8).numpy()
    assert (c[..., 2:4, 2:4] == c[..., 4:6, 4:6]).all()
    idx, _ = TN.lsh_sort(codes)
    np.testing.assert_array_equal(
        idx.numpy(), np.argsort(codes.numpy(), axis=-1, kind='stable'))


def test_nlsn_rotation_draws():
    """Evaluation draws every layer's rotation from a generator seeded 0
    (the same rotation for each layer, as JAX's fixed key); training from
    the step's generator, layer after layer; a wrongly shaped injected
    rotation raises."""
    tm = TN.NLSN(in_chans=1, upscale=2, n_resblocks=8, n_feats=16,
                 n_hashes=2, chunk_size=16, device='cpu')
    shape = tm.NonLocalSparseAttention_0.rotation_shape(64)
    assert shape == (1, 4, 2, 2)
    r0, r1 = tm._rotation(0, shape, 'cpu'), tm._rotation(1, shape, 'cpu')
    assert torch.equal(r0, r1)
    assert torch.equal(r0, torch.randn(shape, generator=torch.Generator()
                                       .manual_seed(0)))
    tm.lsh_generator = torch.Generator().manual_seed(3)
    t0, t1 = tm._rotation(0, shape, 'cpu'), tm._rotation(1, shape, 'cpu')
    assert not torch.equal(t0, t1) and not torch.equal(t0, r0)
    tm.rotations = [np.zeros((1, 4, 2, 3), np.float32)]
    with pytest.raises(ValueError, match='rotation 0'):
        tm._rotation(0, shape, 'cpu')


def _bn_paths(tree):
    return {'.'.join(p.key for p in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize('remat', [False, True])
def test_memnet_training_stats_match_jax(remat):
    """One training forward (and its backward): the port's running
    statistics equal JAX's mutable batch_stats (the chain's statistics
    moved R times in sequence, once per pass), the output equals JAX's,
    with the per-pass checkpoint on and off."""
    kw = dict(_MEM, remat_passes=remat)
    x = np.random.default_rng(1).normal(0.5, 0.2, (2, 1, 8, 8)).astype(
        np.float32)
    jm = JC.MemNet(**kw)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x),
                                         train=False))
    v = {**v, 'batch_stats': _random_stats(v['batch_stats'])}
    out, muts = jax.jit(lambda t: jm.apply(v, t, train=True,
                                           mutable=['batch_stats']))(
        jnp.asarray(x))
    tm = TC.MemNet(device='cpu', **kw)
    tm.load_state_dict(flax_to_torch(v['params'], tm, model_state=v))
    got = tm.train()(torch.from_numpy(x))
    got['out'].square().sum().backward()
    np.testing.assert_allclose(got['out'].detach().numpy(),
                               np.asarray(out['out']), rtol=0, atol=1e-5)
    want = flax_to_torch(v['params'], tm, model_state=muts)
    before = flax_to_torch(v['params'], tm, model_state=v)
    bufs = dict(tm.named_buffers())
    assert len(bufs) == 2 * (2 + 2 * (1 + 2 * 2))
    for k, b in bufs.items():
        assert not torch.equal(want[k], before[k]), k
        np.testing.assert_allclose(b.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _port_step(tm, x, seed_params):
    tm.load_state_dict(seed_params)
    tm.train()
    out = tm(x)
    outs = out.get('intermediate_outs', [out['out']])
    loss = sum(o.square().mean() for o in outs)
    names = [k for k, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       tm.named_parameters()])
    bufs = {k: b.clone() for k, b in tm.named_buffers()}
    return out['out'].detach(), dict(zip(names, grads)), bufs


@pytest.mark.parametrize('net', ['MemNet', 'SRFBN'])
def test_remat_changes_nothing_but_memory(net):
    """MemNet's remat_passes and SRFBN's remat_steps (torch checkpoint):
    the same output, grads and BatchNorm statistics as without, bit for
    bit, and the statistics moved once per application (not again by
    the backward's recompute)."""
    if net == 'MemNet':
        cls, kw, shape = TC.MemNet, dict(_MEM), (2, 1, 8, 8)
        flag = 'remat_passes'
    else:
        cls, flag, shape = TS.SRFBN, 'remat_steps', (2, 1, 6, 6)
        kw = dict(in_chans=1, upscale=2, num_features=8, num_steps=3,
                  num_groups=2)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0.5, 0.2, shape).astype(np.float32))
    ref = cls(device='cpu', **{**kw, flag: False})
    ref.reset_parameters(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    res = {}
    for on in (False, True):
        tm = cls(device='cpu', **{**kw, flag: on})
        res[on] = _port_step(tm, x, init)
        # one forward of the same model without grads: the statistics of
        # one application, to count the updates by
        if on:
            tm.load_state_dict(init)
            with torch.no_grad():
                tm.train()(x)
            once = dict(tm.named_buffers())
    (o0, g0, b0), (o1, g1, b1) = res[False], res[True]
    assert torch.equal(o0, o1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
        assert torch.equal(b1[k], once[k]), k
    if net == 'MemNet':
        assert any(not torch.equal(b1[k], init[k]) for k in b1)


def test_memnet_remat_tree_bridges():
    """JAX's MemNet params with remat_passes on (the lift adds a
    Checkpoint_MemChain_0 level) and off land on the same port names."""
    x = jnp.zeros((1, 1, 8, 8))
    names = {}
    for r in (False, True):
        jm = JC.MemNet(**_MEM, remat_passes=r)
        v = jax.tree.map(np.asarray, jm.init(jax.random.key(0), x))
        tm = TC.MemNet(device='cpu', **_MEM)
        names[r] = set(flax_to_torch(v['params'], tm, model_state=v))
        assert names[r] == set(tm.state_dict())
    assert names[False] == names[True]


def test_srfbn_remat_tree_bridges():
    """SRFBN's remat lift keeps the `feedback` name: the bridge maps a
    remat_steps=True tree as the plain one."""
    kw = dict(in_chans=1, upscale=2, num_features=8, num_steps=2,
              num_groups=2)
    x = jnp.zeros((1, 1, 6, 6))
    trees = [jax.tree.map(np.asarray, JS.SRFBN(remat_steps=r, **kw).init(
        jax.random.key(0), x)['params']) for r in (False, True)]
    tm = TS.SRFBN(device='cpu', **kw)
    a, b = (flax_to_torch(t, tm) for t in trees)
    assert a.keys() == b.keys() == dict(tm.named_parameters()).keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_batchnorm_backward_is_the_gradient():
    """The training BatchNorm's own backward (from the input, mean and
    rsqrt only) against autograd's finite differences in float64, and
    against autograd through the same forward written with plain ops."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((3, 4, 5, 6), generator=gen, dtype=torch.float64)
         * 2 + 1).requires_grad_()
    w = torch.randn(4, generator=gen, dtype=torch.float64).requires_grad_()
    b = torch.randn(4, generator=gen, dtype=torch.float64).requires_grad_()

    def fn(x, w, b):
        return TB._BatchNormTrain.apply(x, w, b, 1e-5, torch.float64)[0]
    assert torch.autograd.gradcheck(fn, (x, w, b))
    g = torch.randn((3, 4, 5, 6), generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(fn(x, w, b), (x, w, b), g)
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    ref = torch.autograd.grad(TB._bn_normalize(x, mean, var, w, b, 1e-5),
                              (x, w, b), g)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('fn', ['sigmoid', 'tanh'])
def test_grl_activations_round_their_backward_once(fn, dtype):
    """GRL's sigmoid and tanh: the forward is torch's; the backward,
    computed in f32 and rounded once, is what torch's CPU backward gives:
    bit for bit in bf16, within f32 rounding in f32 (the CPU's vector
    kernel may fuse a multiply-add)."""
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0, 3, 4096).astype(np.float32)).to(dtype)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, 4096).astype(np.float32)).to(dtype)
    ours = {'sigmoid': TG._Sigmoid.apply, 'tanh': TG._Tanh.apply}[fn]
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = ours(xa), getattr(torch, fn)(xb)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    if dtype == torch.bfloat16:
        assert torch.equal(xa.grad, xb.grad)
    else:
        torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-7)
