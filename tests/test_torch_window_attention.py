"""Port of the unfused SwinIR's eval path (srcaco2_tpu_torch) against the
JAX package on the CPU: K6's plain version against the Pallas kernel in
interpret mode, the unfused SwinIR (both attention branches) through the
bridge's three parameter layouts, the full-image eval forward and the
metrics. Inputs come from numpy seeds.

The JAX side runs in interpret mode where it reaches the Pallas kernel
(patched into swinir.py's call as tests/test_pallas_kernels.py does) and
is compiled with `xla_allow_excess_precision` off: the port rounds after
every op in bf16, as the flax modules are written, while XLA on the CPU
may otherwise keep an elementwise chain in f32 inside a fusion (it skips
the rounding of a residual add that feeds a LayerNorm, and of the exps
that feed a softmax's sum)."""
import contextlib
import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import srcaco2_tpu.ops.pallas.window_attention as jwa
from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.net_defaults import init_net_g
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.models.swinir import shift_attn_mask as j_shift_mask
from srcaco2_tpu.ops import metrics as JM
from srcaco2_tpu.train import evaluator as JE
from srcaco2_tpu.train.steps import make_eval_forward as j_eval_forward
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.models.swinir import SwinBlock
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.ops import metrics as TM
from srcaco2_tpu_torch.ops import window_attention as twa
from srcaco2_tpu_torch.train import evaluator as TE
from srcaco2_tpu_torch.train.steps import make_eval_forward as t_eval_forward

NO_EXCESS = {'xla_allow_excess_precision': False}
# bf16 outputs that both sides round once from f32 results: one output
# ulp (2^-8 relative, at most 2^-7 |ref| above a power of two)
BF16_ULP = dict(atol=1e-2, rtol=2.0 ** -7)


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@contextlib.contextmanager
def _interpret_k6():
    """swinir.py imports window_attention_pallas at call time: patch the
    module attribute to its interpret mode."""
    orig = jwa.window_attention_pallas
    jwa.window_attention_pallas = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        jwa.window_attention_pallas = orig


def _jit(fn, *args):
    """fn compiled for args with XLA's excess precision off, and run."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(
        *args)


# ------------------------------------------------------------------ K6

def _k6_inputs(dtype, mask_kind, w=12, n=64, heads=4, hd=16):
    r = np.random.default_rng(0)
    c = heads * hd
    qkv = r.normal(0, 1, (w, n, 3 * c)).astype(np.float32)
    bias = r.normal(0, 1, (heads, n, n)).astype(np.float32)
    nw = {'none': 0, 'full': w, 'tiled': 4}[mask_kind]
    mask = (r.choice([0.0, -100.0], size=(nw, n, n), p=[0.8, 0.2])
            .astype(np.float32) if nw else None)
    if dtype == 'bf16':     # inputs as the bf16 model hands them over
        rnd = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        qkv, bias = rnd(qkv), rnd(bias)
    return qkv, bias, mask, heads


@pytest.mark.parametrize('mask_kind', ['none', 'full', 'tiled'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_plain_k6_matches_jax_k6(dtype, mask_kind):
    """window_attention_ref against _wmsa_kernel in interpret mode, W=12
    windows (JAX pads them to its 8-window blocks), with no mask, a mask
    per window, and a (4, N, N) mask that window w takes as mask[w % 4]
    (JAX gets it tiled, as swinir.py tiles it)."""
    qkv, bias, mask, heads = _k6_inputs(dtype, mask_kind)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    jmask = None
    if mask is not None:
        jmask = jnp.asarray(np.tile(mask, (qkv.shape[0] // mask.shape[0],
                                           1, 1)), jdt)
    want = np.asarray(jwa.window_attention_pallas(
        jnp.asarray(qkv, jdt), jnp.asarray(bias, jdt), jmask, heads=heads,
        block_windows=8, interpret=True), np.float32)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = twa.window_attention_ref(torch.from_numpy(qkv).to(tdt),
                                   torch.from_numpy(bias).to(tdt), tmask,
                                   heads)
    assert got.dtype == tdt and got.shape == (12, 64, 64)
    if dtype == 'f32':
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_ULP)


def test_k6_wrapper_runs_plain_on_cpu_and_launches_or_raises_elsewhere():
    qkv, bias, mask, heads = _k6_inputs('f32', 'tiled')
    q, b, m = (torch.from_numpy(a) for a in (qkv, bias, mask))
    before = twa.window_attention.launches
    torch.testing.assert_close(twa.window_attention(q, b, m, heads=heads),
                               twa.window_attention_ref(q, b, m, heads),
                               rtol=0, atol=0)
    assert twa.window_attention.launches == before
    # off the CPU: no backward, and no fallback to the plain version
    meta = torch.empty(q.shape, device='meta', requires_grad=True)
    bm = torch.empty(b.shape, device='meta')
    with pytest.raises(RuntimeError, match='no backward'):
        twa.window_attention(meta, bm, None, heads=heads)
    with torch.no_grad(), pytest.raises(ValueError, match='device'):
        twa.window_attention(meta, bm, None, heads=heads)
    assert twa.window_attention.launches == before


def _mma_body_emulation(qkv, bias, mask, heads, lo=True, s_bf16=False):
    """The mma body's arithmetic on the CPU, for bf16 qkv and bias:
    q.k^T in f32 from exact products (bf16 x bf16 fits f32), then the
    f32 scale, the bias and the mask; the f32 softmax; P split into bf16
    P_hi and P_lo = bf16(P - P_hi); both P.v passes summed in f32.
    Returns (the f32 result before rounding, the bf16 output), (W, N, C).
    With lo=False the P_lo pass is left out, with s_bf16 the scaled
    scores are rounded to bf16: arithmetic that keeps less precision.
    """
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    t = qkv.float().reshape(w, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]
    s = (q @ k.transpose(-1, -2)) * torch.tensor(hd ** -0.5)
    if s_bf16:
        s = s.bfloat16().float()
    s = s + bias.float()[None]
    if mask is not None:
        s = s + twa._window_mask(mask, w)[:, None]
    p = torch.softmax(s, dim=-1)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    o = p_hi @ v + p_lo @ v if lo else p_hi @ v
    o = o.permute(0, 2, 1, 3).reshape(w, n, c)
    return o, o.bfloat16()


def _check_mma_emulation(qkv, bias, mask, heads, jmask):
    """The emulation against window_attention_ref and _wmsa_kernel in
    interpret mode (bf16, one output ulp), and its f32 result against
    window_attention_ref in f32 on the same values: within 2^-15 of the
    largest |v| of each output column's head and window (the hi/lo split
    keeps P to ~2^-17 of itself)."""
    q16, b16 = (torch.from_numpy(a).bfloat16() for a in (qkv, bias))
    tmask = None if mask is None else torch.from_numpy(mask)
    o32, out = _mma_body_emulation(q16, b16, tmask, heads)
    ref = twa.window_attention_ref(q16, b16, tmask, heads)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               **BF16_ULP)
    want = np.asarray(jwa.window_attention_pallas(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias, jnp.bfloat16),
        None if jmask is None else jnp.asarray(jmask, jnp.bfloat16),
        heads=heads, block_windows=8, interpret=True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, **BF16_ULP)
    ref32 = twa.window_attention_ref(q16.float(), b16.float(), tmask, heads)
    w, n, c3 = qkv.shape
    hd = c3 // 3 // heads
    v = q16.float().reshape(w, n, 3, heads, hd)[:, :, 2]
    vmax = v.abs().amax(dim=1).reshape(w, 1, heads * hd)
    assert bool(((o32 - ref32).abs() <= 2.0 ** -15 * vmax).all()), float(
        ((o32 - ref32).abs() / vmax).max())


@pytest.mark.parametrize('mask_kind', ['none', 'full', 'tiled'])
def test_mma_body_emulation_matches_plain_and_jax_k6(mask_kind):
    """The mma body's arithmetic (_mma_body_emulation) on _k6_inputs in
    bf16, each mask kind."""
    qkv, bias, mask, heads = _k6_inputs('bf16', mask_kind)
    jmask = None if mask is None else np.tile(
        mask, (qkv.shape[0] // mask.shape[0], 1, 1))
    _check_mma_emulation(qkv, bias, mask, heads, jmask)


def _flagship_k6_inputs():
    """K6's bf16 inputs at the flagship widths: C=180, 6 heads (hd 30),
    the 64 windows of one 64x64 image with the shift-4 mask (numpy
    f32 holding bf16 values)."""
    r = np.random.default_rng(5)
    rnd = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    qkv = rnd(r.normal(0, 1, (64, 64, 3 * 180)))
    bias = rnd(r.normal(0, 1, (6, 64, 64)))
    mask = j_shift_mask(64, 64, 8, 4).astype(np.float32)
    assert mask.shape == (64, 64, 64) and (mask != 0).any()
    return qkv, bias, mask


def test_mma_body_emulation_at_flagship_widths():
    """C=180, 6 heads (hd 30), the 64 windows of one 64x64 image with
    the shift-4 mask, bf16."""
    qkv, bias, mask = _flagship_k6_inputs()
    _check_mma_emulation(qkv, bias, mask, 6, mask)


@pytest.mark.parametrize('arith', ['mma_body', 'no_p_lo', 'scores_bf16'])
def test_k6_precision_gate(arith):
    """chip_smoke.py's wmsa_precision, the gate that holds K6's bf16
    outputs on the card beside WMSA_TOL: it passes the mma body's
    arithmetic (_mma_body_emulation) at the flagship widths, and
    refuses the same arithmetic without the P_lo pass or with the
    scores rounded to bf16, which WMSA_TOL alone passes."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    qkv, bias, mask = (torch.from_numpy(a) for a in _flagship_k6_inputs())
    q16, b16 = qkv.bfloat16(), bias.bfloat16()
    ref = twa.window_attention_ref(q16, b16, mask, 6)
    _, out = _mma_body_emulation(q16, b16, mask, 6,
                                 lo=arith != 'no_p_lo',
                                 s_bf16=arith == 'scores_bf16')
    tol = cs.WMSA_TOL['bf16']
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=tol['atol'], rtol=tol['rtol'])
    got = cs.wmsa_precision(out, ref, q16)
    assert got['ulp_ok'] == (arith == 'mma_body'), got
    if arith == 'mma_body':
        assert got['share_differ_vs_plain'] < 0.2 * cs.WMSA_DIFFER_MAX, got


def test_k6_body_choice_and_operands():
    """_k6_body: the mma body for the flagship's bf16 shape (and 7x7
    windows, and hd 64), the fma body for f32, an odd head width and a
    window block over the mma body's shared-memory budget; the mma body
    gets a bf16 bias as it is handed, the fma body an f32 copy; the
    unfused SwinIR hands the bias over contiguous in the compute
    dtype."""
    bf, f32 = torch.bfloat16, torch.float32
    assert twa._mma_smem_bytes(180) == 110592
    assert twa._k6_body(bf, 64, 180, 6) == 'mma'
    assert twa._k6_body(bf, 49, 180, 6) == 'mma'
    assert twa._k6_body(bf, 64, 256, 4) == 'mma'
    assert twa._k6_body(f32, 64, 180, 6) == 'fma'
    assert twa._k6_body(bf, 64, 45, 3) == 'fma'          # hd 15
    assert twa._mma_smem_bytes(512) > twa.MMA_SMEM_MAX
    assert twa._k6_body(bf, 64, 512, 8) == 'fma'
    b16 = torch.randn(6, 64, 64).bfloat16()
    m = torch.zeros(4, 64, 64)
    got_b, got_m = twa._k6_operands(b16, m, 'mma')
    assert got_b is b16 and got_m is m
    got_b, _ = twa._k6_operands(b16, None, 'fma')
    assert got_b.dtype == f32 and torch.equal(got_b, b16.float())
    seen = []

    def spy(qkv, bias, mask, *, heads):
        seen.append((bias.dtype, bias.is_contiguous()))
        return twa.window_attention_ref(qkv, bias, mask, heads)

    tm = TSwinIR(**_TINY, depths=(2,), num_heads=(2,), fused_blocks=False,
                 use_pallas_attn=True, dtype=bf, device='cpu')
    for mod in tm.modules():
        if hasattr(mod, 'attn_op'):
            mod.attn_op = spy
    launches = dict(twa.window_attention.body_launches)
    with torch.no_grad():
        tm.eval()(torch.rand(1, 1, 8, 8))
    assert seen == [(bf, True)] * 2
    assert twa.window_attention.body_launches == launches


# ------------------------------------------------------ unfused SwinIR

_TINY = dict(in_chans=1, upscale=2, window_size=4, embed_dim=16,
             mlp_ratio=2.0, upsampler='pixelshuffledirect')


def _params(depths, seed=0, **kw):
    """JAX SwinIR (unfused) params as numpy, and the module kwargs."""
    kw = {**_TINY, **kw, 'depths': depths,
          'num_heads': kw.get('num_heads', (2,) * len(depths))}
    init = JSwinIR(**kw)
    ws = kw['window_size']
    p = jax.jit(lambda k: init.init(k, jnp.zeros((1, 1, ws, ws)),
                                    train=False)['params'])(
        jax.random.key(seed))
    return jax.tree.map(np.asarray, p), kw


def _forward_pair(pn, kw, x, dtype, pallas):
    """(JAX output, port output) of one branch and dtype, f32 numpy."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    jm = JSwinIR(**kw, dtype=jdt, use_pallas_attn=pallas)
    with _interpret_k6():
        yj = np.asarray(_jit(lambda p, t: jm.apply(
            {'params': p}, t, train=False)['out'], pn, jnp.asarray(x)))
    tm = TSwinIR(**kw, fused_blocks=False, use_pallas_attn=pallas,
                 dtype=tdt, device='cpu')
    tm.load_state_dict(flax_to_torch(pn, tm))
    with torch.no_grad():
        yt = tm.eval()(torch.from_numpy(x)).numpy()
    assert yt.dtype == np.float32 and yt.shape == yj.shape
    return yj, yt


@pytest.fixture(scope='module')
def unfused_runs():
    """Both branches in f32 and bf16, uniform depths (2, 2) (scanned
    stages of scanned block pairs), a 16x12 LR input (shift masks over
    nW = 12 windows per image, batch 2)."""
    pn, kw = _params((2, 2))
    x = np.random.default_rng(1).uniform(0, 1, (2, 1, 16, 12)).astype(
        np.float32)
    return {(dt, pal): _forward_pair(pn, kw, x, dt, pal)
            for dt in ('f32', 'bf16') for pal in (False, True)}


@pytest.mark.parametrize('pallas', [False, True])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_unfused_swinir_matches_jax(unfused_runs, dtype, pallas):
    yj, yt = unfused_runs[(dtype, pallas)]
    if dtype == 'f32':
        np.testing.assert_allclose(yt, yj, atol=1e-5)
        return
    assert np.abs(yt - yj).max() <= 2e-2
    # the branches are different functions in bf16: each port branch is
    # closer to its own JAX branch than to the other one
    other = unfused_runs[(dtype, not pallas)][0]
    own_err, other_err = np.abs(yt - yj).mean(), np.abs(yt - other).mean()
    assert np.abs(yj - other).mean() > 1e-3
    assert own_err < 0.1 * other_err, (own_err, other_err)


@pytest.mark.parametrize('depths', [(4, 2), (3,), (3, 3)])
def test_bridge_fills_every_unfused_layout(depths):
    """Non-uniform even depths (rstb{s}/blocks/SwinBlock_{0,1}, stacked
    (d/2, ...)), an odd depth (rstb0/SwinBlock_{i}, unrolled) and
    uniform odd depths (stages/RSTB_0/SwinBlock_{i}, stacked (S, ...));
    the uniform even layout is the fixture's. Every leaf lands (the
    bridge raises otherwise) and the forward matches in f32."""
    pn, kw = _params(depths, seed=1)
    x = np.random.default_rng(2).uniform(0, 1, (1, 1, 8, 12)).astype(
        np.float32)
    yj, yt = _forward_pair(pn, kw, x, 'f32', False)
    np.testing.assert_allclose(yt, yj, atol=1e-5)
    tm = TSwinIR(**kw, fused_blocks=False, device='cpu')
    assert len(flax_to_torch(pn, tm)) == len(tm.state_dict())
    assert [len(s.blocks) for s in tm.stages] == list(depths)


def test_bridge_rejects_a_leaf_of_the_other_layout():
    pn, kw = _params((2,))
    tm = TSwinIR(**kw, fused_blocks=True, device='cpu')
    with pytest.raises(KeyError):
        flax_to_torch(pn, tm)


def test_flagship_widths_unfused_forward_matches_jax():
    """C=180, 6 heads (hd 30), ws 8 (N=64), x8 pixelshuffledirect,
    depths (2, 2), one 16x16 LR image, through K6's plain version
    (use_pallas_attn) in f32."""
    pn, kw = _params((2, 2), upscale=8, window_size=8, embed_dim=180,
                     num_heads=(6, 6))
    x = np.random.default_rng(3).uniform(0, 1, (1, 1, 16, 16)).astype(
        np.float32)
    yj, yt = _forward_pair(pn, kw, x, 'f32', True)
    assert yt.shape == (1, 1, 128, 128)
    np.testing.assert_allclose(yt, yj, atol=2e-5)


def test_define_g_builds_the_unfused_layout():
    """swinir_use_fused_blocks=False: the unfused SwinIR with the plain
    attention core, as JAX's define_g; the JAX define_g params bridge
    onto it."""
    args = {'scale': 2, 'n_channels': 1, 'h_size': 32, 'amp': False}
    netG = init_net_g({'net_type': 'SwinIR'}, args)
    netG.update(swinir_window_size=4, swinir_embed_dim=16,
                swinir_depths=[2], swinir_num_heads=[2],
                swinir_upsampler='pixelshuffledirect',
                swinir_use_fused_blocks=False)
    args['netG'] = netG
    tm = t_define_g(args, 'cpu')
    blocks = [m for m in tm.modules() if isinstance(m, SwinBlock)]
    assert len(blocks) == 2 and not any(b.attn.use_pallas for b in blocks)
    jm = j_define_g(args)
    p = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 1, 8, 8)),
                                  train=False)['params'])(jax.random.key(0))
    tm.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, p), tm))


# ------------------------------------------------- eval forward, metrics

@pytest.mark.parametrize('test_mode', [0, 3])
def test_eval_forward_matches_jax(test_mode):
    """make_eval_forward (clip, round, clip to [0, 255]) around the
    unfused SwinIR with K6's plain version, plain and x8 self-ensemble;
    passing the parameters explicitly gives the module's own result."""
    pn, kw = _params((2,))
    jm = JSwinIR(**kw, use_pallas_attn=True)
    tm = TSwinIR(**kw, fused_blocks=False, use_pallas_attn=True,
                 device='cpu')
    tm.load_state_dict(flax_to_torch(pn, tm))
    x = np.random.default_rng(4).uniform(0, 1, (2, 1, 8, 8)).astype(
        np.float32)
    jf = j_eval_forward(jm, 'SwinIR', 2, test_mode=test_mode)
    with _interpret_k6():
        yj = np.asarray(jf(pn, {'l_im': jnp.asarray(x)}))
    tf = t_eval_forward(tm.train(), 'SwinIR', 2, test_mode=test_mode)
    yt = tf(None, {'l_im': torch.from_numpy(x)})
    assert not tm.training and yt.shape == yj.shape == (2, 1, 16, 16)
    assert float(yt.min()) >= 0 and float(yt.max()) <= 255
    np.testing.assert_array_equal(yt.numpy(), np.round(yt.numpy()))
    # f32 sums in another order may move a value across a rounding
    # boundary: one level at most, rarely
    d = np.abs(yt.numpy() - yj)
    assert d.max() <= 1 and (d == 0).mean() >= 0.99
    params = {k: v.clone() for k, v in tm.named_parameters()}
    torch.testing.assert_close(tf(params, {'l_im': torch.from_numpy(x)}),
                               yt, rtol=0, atol=0)


def _images(c, seed):
    r = np.random.default_rng(seed)
    h = r.integers(0, 256, (2, c, 40, 36)).astype(np.float32)
    h[:, :, :8] = r.integers(0, 8, (2, c, 8, 36))   # dark rows: ROI edges
    e = np.clip(h + r.normal(0, 9, h.shape), 0, 255).round().astype(
        np.float32)
    e[1] = h[1]                   # identical images: the MSE floor
    return e, h


@pytest.mark.parametrize('c,border', [(1, 0), (1, 2), (3, 4)])
def test_metrics_match_jax(c, border):
    """compute_metrics, compute_metrics_roi_marginal and make_metric_fn
    on uint8-valued images, 1 or 3 channels, border 0 or the scale; the
    second image of the batch equals its target (PSNR cap)."""
    e, h = _images(c, seed=c + border)
    ths = (4.0, 7.0, 10.0)
    jout = JE.make_metric_fn(border, True, ths)(jnp.asarray(e),
                                                jnp.asarray(h))
    tout = TE.make_metric_fn(border, True, ths)(torch.from_numpy(e),
                                                torch.from_numpy(h))
    assert set(tout) == {'full', 'roi'}
    tol = {'psnr': 1e-3, 'psnr_y': 1e-3, 'mse': 1e-4, 'nrmse': 1e-6,
           'ssim': 2e-6}
    for part in ('full', 'roi'):
        assert set(tout[part]) == set(TE.EVAL_METRICS)
        for k, v in tout[part].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout[part][k]),
                                       rtol=1e-5, atol=tol[k],
                                       err_msg=f'{part} {k}')
    assert float(tout['full']['psnr'][1]) == pytest.approx(TM.PSNR_CAP_DB)
    # the default thresholds are 4..10, as in JAX
    e_t, h_t = torch.from_numpy(e), torch.from_numpy(h)
    torch.testing.assert_close(
        TM.compute_metrics_roi_marginal(e_t, h_t, border),
        TM.compute_metrics_roi_marginal(e_t, h_t, border,
                                        tuple(JC.ROI_THRESH)))
    u = np.random.default_rng(9).uniform(-0.2, 1.2, (2, 1, 5, 5))
    np.testing.assert_array_equal(
        TM.uint8_round(torch.from_numpy(u.astype(np.float32))).numpy(),
        np.asarray(JM.uint8_round(jnp.asarray(u, jnp.float32))))
    rgb = np.random.default_rng(10).uniform(0, 1, (2, 3, 4, 4)).astype(
        np.float32)
    np.testing.assert_allclose(
        TM.rgb2ycbcr(torch.from_numpy(rgb), only_y=False).numpy(),
        np.asarray(JM.rgb2ycbcr(jnp.asarray(rgb), only_y=False)),
        atol=1e-6)


def test_shift_mask_matches_jax():
    from srcaco2_tpu_torch.models.swinir import shift_attn_mask
    for h, w, ws, s in ((16, 12, 4, 2), (64, 64, 8, 4)):
        np.testing.assert_array_equal(shift_attn_mask(h, w, ws, s),
                                      j_shift_mask(h, w, ws, s))
