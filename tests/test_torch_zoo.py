"""The port's zoo nets (srcaco2_tpu_torch/models: SRCNN, VDSR, DFCAN,
MSLapSRN, SRFBN, ENLCN, ACT, OmniSR) against the JAX package's at small
sizes: the same numpy-seeded inputs, JAX's params (jitted init) carried
by bridge.flax_to_torch, the forward within 1e-5 of max|out| in f32 and
within a stated bf16 tolerance (the JAX side compiled without excess
precision, as the port rounds after every op); the transposed conv alone
at every stride the zoo uses, its bilinear init, the patch (un)folds of
ACT, ENLCN's projection buffer and the bridge's refusals."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from srcaco2_tpu.models import act as JA
from srcaco2_tpu.models import blocks as JB
from srcaco2_tpu.models import cnn_pre as JCP
from srcaco2_tpu.models import dfcan as JD
from srcaco2_tpu.models import enlcn as JE
from srcaco2_tpu.models import mslapsr as JM
from srcaco2_tpu.models import omnisr as JO
from srcaco2_tpu.models import srfbn as JS
from srcaco2_tpu.ops import patches as JP
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.models import act as TA
from srcaco2_tpu_torch.models import blocks as TB
from srcaco2_tpu_torch.models import cnn_pre as TCP
from srcaco2_tpu_torch.models import dfcan as TD
from srcaco2_tpu_torch.models import enlcn as TE
from srcaco2_tpu_torch.models import mslapsr as TM
from srcaco2_tpu_torch.models import omnisr as TO
from srcaco2_tpu_torch.models import srfbn as TS
from srcaco2_tpu_torch.ops import patches as TP

@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads: with six test workers each starting one thread
    per core, small ops slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_ACT = dict(in_chans=1, n_feats=8, n_resgroups=2, n_resblocks=2,
            reduction=4, n_heads=4, n_layers=4, n_fusionblocks=2,
            token_size=3, expansion_ratio=2)
_OMNI = dict(in_chans=1, upscale=2, num_feat=16, res_num=1, block_num=1,
             window_size=4, pe=True)

# name: (JAX class, port class, constructor kwargs, input NCHW shape)
NETS = {
    'SRCNN': (JCP.SRCNN, TCP.SRCNN, dict(in_chans=1), (2, 1, 16, 16)),
    'VDSR': (JCP.VDSR, TCP.VDSR, dict(in_chans=1, upscale=2), (2, 1, 8, 8)),
    # an odd height: fftshift2d's own slicing, not torch.fft.fftshift
    'DFCAN': (JD.DFCAN, TD.DFCAN, dict(in_chans=1, upscale=4,
                                       n_resgroups=2), (2, 1, 9, 8)),
    'MSLapSRN': (JM.MSLapSRN, TM.MSLapSRN, dict(in_chans=1, upscale=8),
                 (2, 1, 4, 4)),
    'SRFBN': (JS.SRFBN, TS.SRFBN, dict(in_chans=1, upscale=4,
                                       num_features=8, num_steps=3,
                                       num_groups=2), (2, 1, 6, 6)),
    'ENLCN': (JE.ENLCN, TE.ENLCN, dict(in_chans=1, upscale=2,
                                       n_resblocks=8, n_feats=16,
                                       res_scale=0.1), (2, 1, 8, 8)),
    'ACT': (JA.ACT, TA.ACT, dict(upscale=2, **_ACT), (1, 1, 9, 9)),
    # 16x16 is no multiple of the token size: cropped grids, zero borders
    'ACT_indivisible': (JA.ACT, TA.ACT, dict(upscale=8, **_ACT),
                        (1, 1, 16, 16)),
    'OmniSR': (JO.OmniSR, TO.OmniSR, _OMNI, (1, 1, 16, 16)),
    # not a window multiple: the zero pad and the crop
    'OmniSR_padded': (JO.OmniSR, TO.OmniSR, _OMNI, (1, 1, 14, 15)),
}

# bf16 against JAX's bf16: max |port - jax| <= BF16_TOL * max |jax out|.
# Both round after every op; what differs is the order of the f32 sums
# inside convolutions and products (oneDNN vs XLA), which flips single
# bf16 roundings by an ulp (2^-8 relative) that the layers after carry
# on. Measured on the CPU: up to 1.7e-2 (VDSR's residual, 20 convs),
# within 1.5x of JAX's own bf16-vs-f32 distance on every net; SRCNN and
# SRFBN agree bit for bit or nearly.
BF16_TOL = 3e-2


def enlcn_projection(n_feats, nb_features=128):
    return np.asarray(JE.gaussian_orthogonal_random_matrix(
        jax.random.key(42), nb_features, n_feats // 4))


def pair(name, dtype=jnp.float32):
    """(JAX module, numpy params, port module with them, input)."""
    jcls, tcls, kw, shape = NETS[name]
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    jm = jcls(dtype=dtype, **kw)
    p = jax.jit(lambda k, t: jm.init(k, t, train=False)['params'])(
        jax.random.key(0), jnp.asarray(x))
    pn = jax.tree.map(np.asarray, p)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tm = tcls(dtype=tdt, device='cpu', **kw)
    proj = enlcn_projection(kw['n_feats']) if tcls is TE.ENLCN else None
    tm.load_state_dict(flax_to_torch(pn, tm, projection=proj))
    return jm, pn, tm.eval(), x


def jax_forward(jm, pn, x, exact=False):
    fn = jax.jit(lambda t: jm.apply({'params': pn}, t, train=False))
    if exact:
        fn = fn.lower(jnp.asarray(x)).compile(
            compiler_options={'xla_allow_excess_precision': False})
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        fn(jnp.asarray(x)))


def _outs(d):
    """'out' and every intermediate / residual output, flattened."""
    outs = {'out': d['out']}
    for k in ('x_interp', 'global_residual'):
        if k in d:
            outs[k] = d[k]
    for i, o in enumerate(d.get('intermediate_outs', [])):
        outs[f'inter{i}'] = o
    return outs


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_f32_matches_jax(name):
    jm, pn, tm, x = pair(name)
    ref = _outs(jax_forward(jm, pn, x))
    with torch.no_grad():
        got = _outs(tm(torch.from_numpy(x)))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= 1e-5 * np.abs(r).max() + 1e-7, (k, err)


@pytest.mark.parametrize('name', sorted(NETS))
def test_forward_bf16_matches_jax(name):
    jm, pn, tm, x = pair(name, jnp.bfloat16)
    ref = _outs(jax_forward(jm, pn, x, exact=True))
    with torch.no_grad():
        got = _outs(tm(torch.from_numpy(x)))
    for k, r in ref.items():
        g = got[k].float().numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        err = np.abs(g - r).max()
        assert err <= BF16_TOL * np.abs(r).max(), (k, err)


# (kernel, stride, padding) of every transposed conv in the zoo:
# MSLapSRN's x2 steps and SRFBN's x2 / x4 / x8 projections
CONVT = [(4, 2, 1), (6, 2, 2), (8, 4, 2), (12, 8, 2)]


@pytest.mark.parametrize('k,s,p', CONVT)
def test_convt_matches_flax(k, s, p):
    """The port's ConvT (torch conv_transpose2d over the bridged, flipped
    kernel) against the blocks' ConvT (flax nn.ConvTranspose, VALID, then
    the crop) at f32 within 1e-6; an asymmetric random kernel, so a
    missing flip shows."""
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 7, 3)).astype(
        np.float32)
    jm = JB.ConvT(4, k, s, p)
    pj = jax.jit(jm.init)(jax.random.key(3), jnp.asarray(x))['params']
    y = np.asarray(jax.jit(lambda t: jm.apply({'params': pj}, t))(
        jnp.asarray(x)))
    tm = TB.ConvT(3, 4, k, s, p, device='cpu')
    kern = np.asarray(pj['ConvTranspose_0']['kernel'])
    assert kern.shape == (k, k, 3, 4)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kern[::-1, ::-1].transpose(2, 3, 0, 1))))
        tm.bias.copy_(torch.from_numpy(np.asarray(
            pj['ConvTranspose_0']['bias'])))
        yt = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    yt = yt.permute(0, 2, 3, 1).numpy()
    assert yt.shape == y.shape == (2, 5 * s, 7 * s, 4)
    np.testing.assert_allclose(yt, y, rtol=0, atol=1e-6)


BF16_CONVS = [('Conv', 8, 1, 3), ('Conv', 12, 1, 5)] + [
    ('ConvT', k, s, p) for k, s, p in CONVT]


@pytest.mark.parametrize('kind,k,s,p', BF16_CONVS)
def test_bf16_conv_on_the_cpu(kind, k, s, p):
    """A bf16 Conv / ConvT over 8 channels on the CPU, forward and
    backward, within 2^-7 relative L2 (a bf16 rounding or two) of float64
    on the same bf16 operands. PyTorch 2.13's oneDNN bf16 convolution is
    wrong for 8x8 / 12x12 kernels over 8 input channels: in a
    convolution's forward, and in a transposed convolution's backward,
    whose input grad is such a convolution (SRFBN's x8 ConvT, 12 / 8 /
    2)."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(dtype=torch.bfloat16, device='cpu')
    m = (TB.Conv(8, 8, k, padding=p, **kw) if kind == 'Conv'
         else TB.ConvT(8, 8, k, s, p, **kw))
    m.reset_parameters(gen)
    with torch.no_grad():
        m.bias.copy_(torch.randn(8, generator=gen))
    x = torch.randn((2, 8, 9, 9), generator=gen, requires_grad=True)
    y = m(x)
    g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
    y.backward(g)

    def wide(t):
        return t.detach().to(torch.bfloat16).double().requires_grad_()

    x64, w64, b64 = wide(x), wide(m.weight), wide(m.bias)
    conv = (F.conv2d(x64, w64, padding=p) if kind == 'Conv'
            else F.conv_transpose2d(x64, w64, stride=s, padding=p))
    y64 = conv + b64[:, None, None]
    y64.backward(g.double())
    for got, ref in ((y, y64), (x.grad, x64.grad), (m.weight.grad, w64.grad),
                     (m.bias.grad, b64.grad)):
        got, ref = got.detach().double(), ref.detach()
        assert float((got - ref).norm() / ref.norm()) <= 2.0 ** -7


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_leaky_relu_matches_flax(dtype):
    """MSLapSRN's leaky ReLU against flax's nn.leaky_relu(x, 0.2), output
    and grad bit for bit: in bf16 the slope is bf16(0.2), as jnp rounds a
    weakly typed constant (F.leaky_relu's f32 0.2 differs on a tenth of
    the outputs)."""
    from flax import linen as fnn
    x = np.random.default_rng(2).normal(size=(4096,)).astype(np.float32)
    g = np.random.default_rng(3).normal(size=(4096,)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    yj, vjp = jax.vjp(lambda t: fnn.leaky_relu(t, 0.2), xj)
    (gj,) = vjp(jnp.asarray(g, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    yt = TM._lrelu(xt)
    yt.backward(torch.from_numpy(g).to(yt.dtype))
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(gj.astype(jnp.float32)))


def test_bilinear_init_lands_on_the_same_taps():
    """MSLapSRN's bilinear-initialised transposed convs: the port's
    initial weights equal the bridged JAX initial weights (the filter is
    symmetric, so the flip between layouts keeps its taps)."""
    jm, pn, tm, _ = pair('MSLapSRN')
    fresh = TM.MSLapSRN(in_chans=1, upscale=8, device='cpu')
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    bridged = dict(tm.named_parameters())
    names = [k for k, m in fresh.named_modules() if isinstance(m, TB.ConvT)]
    assert len(names) == 6
    for k in names:
        np.testing.assert_array_equal(
            getattr(fresh.get_submodule(k), 'weight').detach().numpy(),
            bridged[f'{k}.weight'].detach().numpy())


@pytest.mark.parametrize('hw', [(9, 12), (16, 16), (14, 11)])
def test_patches_match_jax(hw):
    """unfold / fold, non-overlapping (k = 3) and k = 2s (s = 3), on
    divisible and indivisible sizes: the port's tokens and images equal
    JAX's."""
    x = np.random.default_rng(2).normal(0, 1, (2, *hw, 5)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    for unfold, fold in ((JP.unfold_nonoverlap, JP.fold_nonoverlap),
                         (JP.unfold_k2s, JP.fold_k2s)):
        tj = np.asarray(unfold(jnp.asarray(x), 3))
        tt = getattr(TP, unfold.__name__)(xt, 3)
        np.testing.assert_array_equal(tt.numpy(), tj)
        yj = np.asarray(fold(jnp.asarray(tj), 3, hw))
        yt = getattr(TP, fold.__name__)(torch.from_numpy(tj), 3, hw)
        np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-6)


def test_enlcn_projection_buffer():
    """The port's ENLCA draws its projection at construction from a
    torch.Generator seeded 42 (orthogonal blocks with chi row norms, not
    JAX's numbers); the bridge replaces it with JAX's matrix, which the
    port's state_dict then carries."""
    tm = TE.ENLCN(in_chans=1, upscale=2, n_resblocks=8, n_feats=16,
                  device='cpu')
    bufs = {k: v for k, v in tm.state_dict().items() if k.endswith('proj')}
    assert sorted(bufs) == ['ENLCA_0.proj', 'ENLCA_1.proj']
    own = bufs['ENLCA_0.proj']
    assert own.shape == (128, 4)
    assert torch.equal(own, TE.ENLCN(in_chans=1, upscale=2, n_resblocks=8,
                                     n_feats=16, device='cpu'
                                     ).state_dict()['ENLCA_1.proj'])
    # each block of 4 rows is orthogonal up to the row norms
    blk = own[:4] / own[:4].norm(dim=1, keepdim=True)
    torch.testing.assert_close(blk @ blk.T, torch.eye(4), atol=1e-5,
                               rtol=0)
    jproj = enlcn_projection(16)
    assert not np.allclose(own.numpy(), jproj)
    _, pn, tm2, _ = pair('ENLCN')
    for k in bufs:
        np.testing.assert_array_equal(tm2.state_dict()[k].numpy(), jproj)
    assert not any(k.endswith('proj') for k in flax_to_torch(pn, tm2))


def test_bridge_raises_on_unmatched_leaves():
    _, pn, tm, _ = pair('VDSR')
    extra = {**pn, 'Conv_99': {'kernel': np.zeros((3, 3, 64, 64))}}
    with pytest.raises(KeyError, match='Conv_99'):
        flax_to_torch(extra, tm)
    short = {k: v for k, v in pn.items() if k != 'Conv_3'}
    with pytest.raises(KeyError, match='Conv_3.weight'):
        flax_to_torch(short, tm)
    bad = {**pn, 'Conv_0': {'kernel': np.zeros((5, 5, 1, 64))}}
    with pytest.raises(ValueError, match='Conv_0.weight'):
        flax_to_torch(bad, tm)
