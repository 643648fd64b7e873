"""The zoo's third part (srcaco2_tpu_torch/models: DBPN, ProSR,
DSR-Splines, CSR-CNN, EDSR-LIIF) against the JAX package's at small
widths, as tests/test_torch_zoo.py and test_torch_zoo2.py hold the first
two: the same numpy-seeded inputs, JAX's params (jitted init) carried by
bridge.flax_to_torch, every output within 1e-5 of max|out| in f32 and
within BF16_TOL of it in bf16 (the JAX side compiled without excess
precision, as the port rounds after every op).

Also: DBPN's params made with remat_blocks on and off bridge to the same
port state (the names match, not the order) and give the same outputs;
DSR-Splines' knot masks equal JAX's, on uniform inputs and on uint8
levels with flat regions (bicubic values within an ulp of a knot
boundary); CSR-CNN's segmentation outputs in training and evaluation
(the softmax rounded as jax.nn.softmax rounds in bf16); EDSR-LIIF with
each decoder flag off in turn, against both of JAX's gather paths
(SRCACO2_LIIF_ONEHOT=1, its default one-hot products, and 0, the
take), its constants built as JAX builds them, and the gather's
backward against JAX's one-hot VJP in bf16 and f32."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.models import blocks as JB
from srcaco2_tpu.models import csrcnn as JC
from srcaco2_tpu.models import dbpn as JD
from srcaco2_tpu.models import dsr_splines as JS
from srcaco2_tpu.models import edsr_liif as JL
from srcaco2_tpu.models import prosr as JP
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.models import blocks as TB
from srcaco2_tpu_torch.models import csrcnn as TC
from srcaco2_tpu_torch.models import dbpn as TD
from srcaco2_tpu_torch.models import dsr_splines as TS
from srcaco2_tpu_torch.models import edsr_liif as TL
from srcaco2_tpu_torch.models import prosr as TP

from test_torch_zoo import BF16_TOL


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_DBPN = dict(in_chans=1, base_filter=8, feat=16, num_stages=2)
_PROSR = dict(in_chans=1, num_init_features=16, growth_rate=8, bn_size=2,
              level_config={2: [[2, 2]], 4: [[2], [2]],
                            8: [[2], [1], [1]]})
_SPL = dict(in_planes=1, upscale=2, n_splines_per_color=16)
_UNET = dict(in_planes=1, upscale=2, net_type='unet', inner_channel=8,
             res_blocks=1)
_LIIF = dict(in_chans=1, upscale=4, n_feats=8, n_resblocks=2, hidden=16)

# name: (JAX class, port class, constructor kwargs, input NCHW shape,
# train mode). CSR-CNN's unet and small CNNs take the HR-sized
# pre-upscale, its pyramid the LR.
NETS = {
    'DBPN_x2': (JD.DBPN, TD.DBPN, dict(_DBPN, upscale=2), (2, 1, 6, 6)),
    'DBPN_x4': (JD.DBPN, TD.DBPN, dict(_DBPN, upscale=4, num_stages=1),
                (1, 1, 5, 4)),
    'DBPN_x8': (JD.DBPN, TD.DBPN, dict(_DBPN, upscale=8, num_stages=1),
                (1, 1, 3, 3)),
    'ProSR_x2': (JP.ProSR, TP.ProSR, dict(_PROSR, upscale=2), (2, 1, 6, 6)),
    'ProSR_x4': (JP.ProSR, TP.ProSR, dict(_PROSR, upscale=4), (1, 1, 5, 6)),
    'ProSR_x8': (JP.ProSR, TP.ProSR, dict(_PROSR, upscale=8,
                                          ps_woReLU=True), (1, 1, 4, 4)),
    'DSRSplines': (JS.DSRSplines, TS.DSRSplines, _SPL, (2, 1, 8, 8)),
    'DSRSplines_local': (JS.DSRSplines, TS.DSRSplines,
                         dict(_SPL, splinenet_type='snet_type2',
                              use_local_residual=True), (1, 1, 8, 8)),
    'DSRSplines_global': (JS.DSRSplines, TS.DSRSplines,
                          dict(_SPL, splinenet_type='snet_type3',
                               n_splines_per_color=8,
                               use_local_residual=True,
                               use_global_residual=True), (1, 1, 8, 8)),
    'CSRCNN_unet': (JC.CSRCNN, TC.CSRCNN, _UNET, (2, 1, 16, 16)),
    'CSRCNN_seg': (JC.CSRCNN, TC.CSRCNN,
                   dict(_UNET, net_task='segmentation'), (1, 1, 12, 16)),
    'CSRCNN_seg_train': (JC.CSRCNN, TC.CSRCNN,
                         dict(_UNET, net_task='segmentation'),
                         (1, 1, 12, 16), True),
    'CSRCNN_pyramid': (JC.CSRCNN, TC.CSRCNN,
                       dict(_UNET, net_type='pyramid',
                            use_global_residual=True), (2, 1, 6, 6)),
    'CSRCNN_snet1': (JC.CSRCNN, TC.CSRCNN,
                     dict(_UNET, net_type='snet_type1'), (2, 1, 12, 12)),
    'CSRCNN_snet2_local': (JC.CSRCNN, TC.CSRCNN,
                           dict(_UNET, net_type='snet_type2',
                                use_local_residual=True), (1, 1, 12, 12)),
    'CSRCNN_snet3': (JC.CSRCNN, TC.CSRCNN,
                     dict(_UNET, net_type='snet_type3',
                          use_local_residual=True, use_global_residual=False),
                     (1, 1, 8, 8)),
    'EDSR_LIIF': (JL.EDSRLIIF, TL.EDSRLIIF, _LIIF, (2, 1, 5, 6)),
    'EDSR_LIIF_no_ensemble': (JL.EDSRLIIF, TL.EDSRLIIF,
                              dict(_LIIF, local_ensemble=False),
                              (1, 1, 5, 6)),
    'EDSR_LIIF_no_unfold': (JL.EDSRLIIF, TL.EDSRLIIF,
                            dict(_LIIF, feat_unfold=False), (1, 1, 5, 6)),
    'EDSR_LIIF_no_cell': (JL.EDSRLIIF, TL.EDSRLIIF,
                          dict(_LIIF, cell_decode=False, upscale=2),
                          (1, 1, 5, 6)),
}
_OUT_KEYS = ('out', 'x_interp', 'global_residual', 'raw_segmentation',
             'expected_pred')


def _outs(d):
    """Every output of a net's dict, intermediate levels flattened."""
    outs = {k: d[k] for k in _OUT_KEYS if k in d}
    for i, o in enumerate(d.get('intermediate_outs', [])):
        outs[f'inter{i}'] = o
    return outs


def _input(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _init(name):
    """JAX's params of NETS[name] (jitted init; f32 params whatever the
    compute dtype), once per name: the f32 and bf16 tests of a net share
    them."""
    jcls, _, kw, shape, *_ = NETS[name]
    jm = jcls(**kw)
    return jax.tree.map(np.asarray, jax.jit(
        lambda k, t: jm.init(k, t, train=False)['params'])(
        jax.random.key(0), jnp.asarray(_input(shape))))


def pair(name, dtype=jnp.float32):
    """(JAX module, params, port module with them, input, train)."""
    jcls, tcls, kw, shape, *train = NETS[name]
    train = bool(train and train[0])
    x = _input(shape)
    jm = jcls(dtype=dtype, **kw)
    pn = _init(name)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tm = tcls(dtype=tdt, device='cpu', **kw)
    tm.load_state_dict(flax_to_torch(pn, tm))
    return jm, pn, tm.train(train), x, train


def jax_forward(jm, pn, x, train=False, exact=False):
    fn = jax.jit(lambda t: jm.apply({'params': pn}, t, train=train))
    if exact:
        fn = fn.lower(jnp.asarray(x)).compile(
            compiler_options={'xla_allow_excess_precision': False})
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        fn(jnp.asarray(x)))


def _port_forward(tm, x):
    with torch.no_grad():
        return _outs(tm(torch.from_numpy(x)))


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_f32_matches_jax(name):
    jm, pn, tm, x, train = pair(name)
    ref = _outs(jax_forward(jm, pn, x, train))
    got = _port_forward(tm, x)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= 1e-5 * np.abs(r).max() + 1e-7, (k, err)
        assert np.linalg.norm(g - r) <= 1e-5 * np.linalg.norm(r) + 1e-7, k


def _argmax_held(g, r, logits, logits_port):
    """The evaluation `out` of the segmentation net (argmax / 255) in
    bf16: equal wherever JAX's two largest logits lie further apart than
    twice the largest difference between the two packages' logits (held
    within BF16_TOL); elsewhere the two bf16 computations may rank them
    either way."""
    err = np.abs(logits_port - logits).max()
    assert err <= BF16_TOL * np.abs(logits).max()
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0])[:, None] > 2 * err
    assert clear.mean() > 0.5, clear.mean()
    # the levels equal; the quotient level / 255 within an f32 ulp
    np.testing.assert_array_equal(np.round(g * 255)[clear],
                                  np.round(r * 255)[clear])
    np.testing.assert_allclose(g[clear], r[clear], rtol=2 ** -23, atol=0)


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_bf16_matches_jax(name):
    jm, pn, tm, x, train = pair(name, jnp.bfloat16)
    ref = _outs(jax_forward(jm, pn, x, train, exact=True))
    got = _port_forward(tm, x)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        if k == 'out' and 'raw_segmentation' in ref and not train:
            _argmax_held(g, r, ref['raw_segmentation'],
                         got['raw_segmentation'].float().numpy())
            continue
        err = np.abs(g - r).max()
        assert err <= BF16_TOL * np.abs(r).max(), (k, err)


def test_dbpn_remat_settings_bridge_to_one_state():
    """JAX's DBPN with remat_blocks on and off: the same flax names (no
    lift level), the same drawn values, so the same port state; and the
    same outputs on both sides."""
    kw = dict(_DBPN, upscale=2, num_stages=1)
    x = _input((1, 1, 4, 4), 3)
    states, outs = [], []
    for remat in (True, False):
        jm = JD.DBPN(remat_blocks=remat, **kw)
        pn = jax.tree.map(np.asarray, jax.jit(
            lambda k, t: jm.init(k, t, train=False)['params'])(
            jax.random.key(1), jnp.asarray(x)))
        outs.append(np.asarray(jax.jit(
            lambda t: jm.apply({'params': pn}, t, train=True))(
            jnp.asarray(x))['out']))
        tm = TD.DBPN(remat_blocks=remat, device='cpu', **kw)
        states.append(flax_to_torch(pn, tm))
        tm.load_state_dict(states[-1])
        outs.append(tm.train()(torch.from_numpy(x))['out'].detach().numpy())
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    np.testing.assert_allclose(outs[1], outs[0], rtol=0,
                               atol=1e-5 * np.abs(outs[0]).max())


def test_dbpn_remat_blocks_are_checkpointed():
    """remat_blocks runs each projection block under the checkpoint in
    training with grads (its activations are recomputed in the
    backward), and changes neither the outputs nor the grads."""
    kw = dict(_DBPN, upscale=2, num_stages=1)
    x = torch.from_numpy(_input((1, 1, 5, 5), 4))
    res = []
    for remat in (False, True):
        tm = TD.DBPN(remat_blocks=remat, device='cpu', **kw)
        tm.reset_parameters(torch.Generator().manual_seed(0))
        calls = []
        orig = TD.checkpointed

        def spy(module, *a):
            calls.append(module)
            return orig(module, *a)
        TD.checkpointed = spy
        try:
            out = tm.train()(x)['out']
        finally:
            TD.checkpointed = orig
        out.square().mean().backward()
        res.append((out.detach(), [p.grad for p in tm.parameters()]))
        assert len(calls) == (13 if remat else 0)
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)


def _jax_masks(x, kw):
    """JAX's knot masks (B, S, H, W) for the input x."""
    y = np.asarray(JB.bicubic_up(jnp.asarray(x), kw['upscale']))
    knots = JS.make_knots(0, 255, kw['n_splines_per_color'])
    x_un = np.clip(np.floor(y * np.float32(255)), 0, 255)
    return np.stack([(x_un[:, 0] >= lo) & (x_un[:, 0] <= hi)
                     for lo, hi in knots], 1).astype(np.float32), y


@pytest.mark.parametrize('levels', [False, True])
def test_dsr_spline_masks_match_jax(levels):
    """The knot masks from the port's f32 bicubic upscale equal JAX's, on
    a uniform input and on uint8 levels with flat 4x4 regions, where the
    upscale is k/255 up to an ulp and floor(y * 255) lands on a knot
    boundary's either side by rounding; each pixel in exactly one knot.
    The masked outputs then agree."""
    kw = dict(_SPL, upscale=4)
    if levels:
        r = np.random.default_rng(5)
        lv = r.integers(0, 256, (2, 1, 4, 4)).repeat(4, 2).repeat(4, 3)
        x = (lv / 255.0).astype(np.float32)
    else:
        x = _input((2, 1, 16, 16), 5)
    want, y = _jax_masks(x, kw)
    x_up = TB.bicubic_up(torch.from_numpy(x), kw['upscale'])
    np.testing.assert_array_equal(x_up.numpy(), y)
    tm = TS.DSRSplines(device='cpu', **kw)
    got = tm.masks(x_up).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == 1).all()
    if levels:      # the flat regions put values on the knots' bounds
        lows = np.array([lo for lo, _ in tm.knots])
        assert np.isin(np.floor(y * 255), lows).any()


def _liif_pair(monkeypatch, onehot, dtype=jnp.float32, **kw):
    monkeypatch.setenv('SRCACO2_LIIF_ONEHOT', onehot)
    name = '_liif' + ''.join(f'_{k}{v}' for k, v in sorted(kw.items()))
    monkeypatch.setitem(NETS, name, (JL.EDSRLIIF, TL.EDSRLIIF,
                                     dict(_LIIF, **kw), (2, 1, 5, 6)))
    return pair(name, dtype)


@pytest.mark.parametrize('onehot', ['1', '0'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_liif_against_both_gather_paths(onehot, dtype, monkeypatch):
    jdt = jnp.float32 if dtype == 'f32' else jnp.bfloat16
    jm, pn, tm, x, _ = _liif_pair(monkeypatch, onehot, jdt, upscale=3)
    r = jax_forward(jm, pn, x, exact=True)['out']
    g = _port_forward(tm, x)['out'].float().numpy()
    tol = 1e-5 if dtype == 'f32' else BF16_TOL
    assert np.abs(g - r).max() <= tol * np.abs(r).max()


@pytest.mark.parametrize('s', [2, 3, 8])
def test_liif_constants_are_jax_s(s):
    """The gather indices, rel / cell inputs and area weights: the numpy
    constants of JAX's module, bit for bit, with every LR row and column
    covered by each gather's segments once."""
    hl, wl = 5, 7
    branches, weights = TL.liif_plan(hl, wl, s, True, True)
    hh, wh = hl * s, wl * s
    for (iy, ix, rc) in branches:
        assert rc.dtype == np.float32 and rc.shape == (hh, wh, 4)
        assert (np.diff(iy) >= 0).all() and (np.diff(ix) >= 0).all()
        for idx, n in ((iy, hl), (ix, wl)):
            seg = TL._segments(idx, n)
            taken = seg[seg < len(idx)]
            np.testing.assert_array_equal(np.sort(taken),
                                          np.arange(len(idx)))
            np.testing.assert_array_equal(idx[seg[:, 0][seg[:, 0]
                                                          < len(idx)]],
                                          np.unique(idx))
    assert all(w.dtype == np.float32 for w in weights)
    np.testing.assert_allclose(sum(weights), 1.0, rtol=1e-6)
    # JAX's rel of branch 0 through its own expressions
    yq = (np.arange(hh) + 0.5) / hh * 2 - 1
    yl = (np.arange(hl) + 0.5) / hl * 2 - 1
    iy0 = np.clip(((yq + 1) / 2 * hl - 0.5), 0, hl - 1)
    iy = np.clip(np.round(iy0 - 0.5), 0, hl - 1).astype(np.int32)
    np.testing.assert_array_equal(branches[0][0], iy)
    np.testing.assert_array_equal(branches[0][2][:, 0, 0],
                                  ((yq - yl[iy]) * hl).astype(np.float32))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_gather_backward_matches_jax_onehot_vjp(dtype):
    """The gather's backward (f32 segment sums, rounded to the compute
    dtype after each axis) against the VJP of JAX's one-hot gather
    (_ensemble_gather with SRCACO2_LIIF_ONEHOT=1: two products, each
    summed in f32 and rounded to the compute dtype) on the same
    cotangent: bit for bit in bf16, within f32 rounding in f32."""
    import os
    hl, wl, s, c = 6, 5, 8, 3
    jdt = jnp.float32 if dtype == 'f32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    r = np.random.default_rng(2)
    z = r.standard_normal((2, hl, wl, c)).astype(np.float32)
    branches, _ = TL.liif_plan(hl, wl, s, True, True)
    prev = os.environ.get('SRCACO2_LIIF_ONEHOT')
    os.environ['SRCACO2_LIIF_ONEHOT'] = '1'
    try:
        for iy, ix, _ in branches:
            g = r.standard_normal((2, hl * s, wl * s, c)).astype(np.float32)
            zj = jnp.asarray(z, jdt)
            out, vjp = jax.vjp(lambda t: JL._ensemble_gather(t, iy, ix), zj)
            (dz_j,) = vjp(jnp.asarray(g, jdt))
            zt = torch.from_numpy(z).to(tdt).requires_grad_()
            lat = TL.ensemble_gather(
                zt, torch.from_numpy(iy.astype(np.int64)),
                torch.from_numpy(ix.astype(np.int64)),
                torch.from_numpy(TL._segments(iy, hl)),
                torch.from_numpy(TL._segments(ix, wl)))
            np.testing.assert_array_equal(lat.detach().float().numpy(),
                                          np.asarray(out, np.float32))
            lat.backward(torch.from_numpy(g).to(tdt))
            got = zt.grad.float().numpy()
            want = np.asarray(dz_j, np.float32)
            if dtype == 'bf16':
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    finally:
        if prev is None:
            del os.environ['SRCACO2_LIIF_ONEHOT']
        else:
            os.environ['SRCACO2_LIIF_ONEHOT'] = prev


@pytest.mark.parametrize('stride,groups', [(1, 1), (2, 4)])
def test_f32_conv_weight_grad_path(stride, groups):
    """blocks._Conv2dF32, the card's f32 conv2d whose weight grad runs
    without cuDNN: the same forward and grads as F.conv2d's autograd
    (here on the CPU, bit for bit)."""
    r = torch.Generator().manual_seed(8)
    x = torch.randn(2, 8, 11, 12, generator=r)
    w = torch.randn(16, 8 // groups, 5, 5, generator=r)
    g = torch.randn(2, 16, (11 - 1) // stride + 1, (12 - 1) // stride + 1,
                    generator=r)
    outs = []
    for fn in (lambda a, b: torch.nn.functional.conv2d(
            a, b, stride=stride, padding=2, groups=groups),
               lambda a, b: TB._Conv2dF32.apply(a, b, stride, 2, groups)):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        y.backward(g)
        outs.append((y.detach(), a.grad, b.grad))
    for p, q in zip(*outs):
        assert torch.equal(p, q)
