"""The fused Swin block pair with its backward (srcaco2_tpu_torch/ops/
swin_block.py, K3 + K4) against the JAX package: the plain PyTorch
versions and the autograd Function against the Pallas pair kernel and
its custom VJP run in interpret mode, the pair's f32 stream against two
chained blocks, and the CUDA kernels' per-patch design (three phases
over window index tables, an f32 scratch between the blocks, the
reductions) emulated in PyTorch against the plain versions. The CUDA
kernels themselves run only on the card (chip_smoke.py holds them
against the plain versions there)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.ops.pallas import swin_block as jsb
from srcaco2_tpu_torch.ops import swin_block as tsb

from test_torch_block_train import (B, C, DTYPES, FWD_TOL, GRAD_L2_BF16, H,
                                    KEYS, NH, W, WS, EmuGrads, _close,
                                    _jax_names, _params, emu_layout,
                                    emu_window_bwd, emu_window_fwd)

WINDOWS = ((H, W, WS, 0), (H, W, WS, WS // 2))


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


def _pair_inputs(seed, b=B, h=H, w=W, c=C, ws=WS):
    """x, dout (unit normal), and the biases of blocks A (shift 0) and B
    (shift ws/2) from random tables."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h * w, c)).astype(np.float32)
    dout = r.normal(0, 1, (b, h * w, c)).astype(np.float32)
    table = r.normal(0, 0.02, (2, (2 * ws - 1) ** 2, NH)).astype(np.float32)
    bias = tsb.build_attn_bias(torch.from_numpy(table), h, w, ws)
    return x, dout, bias[0].numpy(), bias[1].numpy()


def _torch(p, requires_grad=False):
    return {k: torch.from_numpy(v).requires_grad_(requires_grad)
            for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _jax_pair_vjp(cdt_name):
    jdt = DTYPES[cdt_name][0]

    def f(x, pa, ba, pb, bb, dout):
        out, vjp = jax.vjp(
            lambda *a: jsb.fused_swin_block_pair(
                *a, heads=NH, interpret=True, compute_dtype=jdt),
            x, pa, ba, pb, bb)
        return out, vjp(dout)
    return jax.jit(f)


@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_plain_pair_and_grads_match_jax_kernel(dt):
    """K3's and K4's plain versions, through the autograd Function on
    CPU tensors, against fused_swin_block_pair's forward and custom VJP
    in interpret mode: the output, dx, the 24 weight grads and both
    dbias."""
    jdt, tdt = DTYPES[dt]
    x, dout, ba, bb = _pair_inputs(7)
    pa, pb = _params(8), _params(9)
    out_j, (dx_j, dpa_j, dba_j, dpb_j, dbb_j) = _jax_pair_vjp(dt)(
        jnp.asarray(x, jdt), _jax_names(pa), jnp.asarray(ba),
        _jax_names(pb), jnp.asarray(bb), jnp.asarray(dout, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pat, pbt = _torch(pa, True), _torch(pb, True)
    bat = torch.from_numpy(ba).requires_grad_()
    bbt = torch.from_numpy(bb).requires_grad_()
    before = (tsb.swin_block_pair_fwd.launches,
              tsb.swin_block_pair_bwd.launches)
    out_t = tsb.fused_swin_block_pair(xt, pat, bat, pbt, bbt, heads=NH,
                                      windows=WINDOWS, compute_dtype=tdt)
    out_t.backward(torch.from_numpy(dout).to(tdt))
    # CPU tensors run the plain versions and launch nothing
    assert (tsb.swin_block_pair_fwd.launches,
            tsb.swin_block_pair_bwd.launches) == before
    assert out_t.dtype == xt.grad.dtype == tdt
    fwd_err = np.abs(out_t.detach().float().numpy()
                     - np.asarray(out_j, np.float32)).max()
    assert fwd_err <= FWD_TOL[dt], fwd_err
    _close('dx', xt.grad.float(), dx_j, dt)
    _close('dbias_a', bat.grad, dba_j, dt)
    _close('dbias_b', bbt.grad, dbb_j, dt)
    for name, pt, dp_j in (('a', pat, dpa_j), ('b', pbt, dpb_j)):
        for k in KEYS:
            _close(f'{k}_{name}', pt[k].grad,
                   dp_j[k.replace('_weight', '_scale')], dt)


# ways of rounding the pair's backward as two chained blocks would, each
# with the tensors it moves furthest from the JAX pair's VJP
_DEVIATIONS = {
    # K2's rounding set: 1/r, dp, rs and dp - rs rounded to bf16
    'k2_rounding': (lambda bwd_math: lambda *a, pair_rounding: bwd_math(
        *a, pair_rounding=False),
        ('dbias_a', 'dbias_b', 'qkv_kernel_a', 'qkv_kernel_b')),
    # block B's dx rounded to bf16 before block A's backward
    'rounded_grad': (lambda bwd_math: lambda g, *a, pair_rounding: bwd_math(
        g.to(torch.bfloat16).float(), *a, pair_rounding=pair_rounding),
        ('dx', 'dbias_a', 'proj_bias_a', 'mlp2_bias_a')),
}


@pytest.mark.parametrize('deviation', sorted(_DEVIATIONS))
def test_pair_backward_rounds_as_block_bwd_math(monkeypatch, deviation):
    """bf16: the pair's backward keeps 1/r, dp, rs and dp - rs in f32
    (_block_bwd_math, where the per-block backward rounds them) and
    feeds block B's dx to block A unrounded. The plain version is closer
    to the JAX pair's VJP than the same function with either deviation,
    in every tensor that deviation moves."""
    jdt, tdt = DTYPES['bf16']
    x, dout, ba, bb = _pair_inputs(7)
    pa, pb = _params(8), _params(9)
    _, (dx_j, dpa_j, dba_j, dpb_j, dbb_j) = _jax_pair_vjp('bf16')(
        jnp.asarray(x, jdt), _jax_names(pa), jnp.asarray(ba),
        _jax_names(pb), jnp.asarray(bb), jnp.asarray(dout, jdt))
    deviate, names = _DEVIATIONS[deviation]
    refs = dict(dx=dx_j, dbias_a=dba_j, dbias_b=dbb_j,
                **{f'{k}_a': dpa_j[k] for k in ('qkv_kernel', 'proj_bias',
                                                 'mlp2_bias')},
                qkv_kernel_b=dpb_j['qkv_kernel'])

    def errs():
        dx, ga, dba, gb, dbb = tsb.swin_block_pair_bwd_ref(
            torch.from_numpy(x).to(tdt), torch.from_numpy(dout).to(tdt),
            _torch(pa), torch.from_numpy(ba), _torch(pb),
            torch.from_numpy(bb), heads=NH, compute_dtype=tdt)
        got = dict(dx=dx.float(), dbias_a=dba, dbias_b=dbb,
                   **{f'{k}_a': ga[k] for k in ('qkv_kernel', 'proj_bias',
                                                'mlp2_bias')},
                   qkv_kernel_b=gb['qkv_kernel'])
        return {k: np.linalg.norm(got[k].numpy() - np.asarray(refs[k]))
                / np.linalg.norm(np.asarray(refs[k])) for k in names}
    pair = errs()
    monkeypatch.setattr(tsb, '_bwd_math', deviate(tsb._bwd_math))
    other = errs()
    assert all(pair[k] < other[k] for k in names), (pair, other)


def _pair_and_chain(dt, x, dout, ba, bb, pa, pb):
    """(out, dx) of the port's pair and of two chained fused blocks,
    from the same inputs."""
    tdt = DTYPES[dt][1]
    res = []
    for chained in (False, True):
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        bat, bbt = torch.from_numpy(ba), torch.from_numpy(bb)
        if chained:
            mid = tsb.fused_swin_block(xt, _torch(pa), bat, heads=NH,
                                       window=WINDOWS[0], compute_dtype=tdt)
            out = tsb.fused_swin_block(mid, _torch(pb), bbt, heads=NH,
                                       window=WINDOWS[1], compute_dtype=tdt)
        else:
            out = tsb.fused_swin_block_pair(
                xt, _torch(pa), bat, _torch(pb), bbt, heads=NH,
                windows=WINDOWS, compute_dtype=tdt)
        out.backward(torch.from_numpy(dout).to(tdt))
        res.append((out.detach().float(), xt.grad.float()))
    return res


def test_pair_keeps_the_stream_in_f32():
    """In bf16 the pair is not two chained blocks: block A's output
    reaches block B in f32 and the backward keeps 1/r, dp and rs in f32,
    in the port as in JAX. In f32 the two agree to 2e-6 (the JAX
    package's own check, tests/test_swin_fused.py:271)."""
    x, dout, ba, bb = _pair_inputs(10)
    pa, pb = _params(11), _params(12)
    (out_p, dx_p), (out_c, dx_c) = _pair_and_chain('f32', x, dout, ba, bb,
                                                   pa, pb)
    assert (out_p - out_c).abs().max() <= 2e-6
    assert (dx_p - dx_c).abs().max() <= 1e-4 * dx_c.abs().max()
    (out_p, dx_p), (out_c, dx_c) = _pair_and_chain('bf16', x, dout, ba, bb,
                                                   pa, pb)
    assert (out_p != out_c).float().mean() > 0.05
    assert (dx_p != dx_c).float().mean() > 0.05
    # the JAX pair differs from its chain of per-block kernels the same way
    jdt = jnp.bfloat16

    def jblock(z, p, bias):
        return jsb.fused_swin_block(z, _jax_names(p), jnp.asarray(bias),
                                    heads=NH, interpret=True,
                                    compute_dtype=jdt)
    xj = jnp.asarray(x, jdt)
    pair_j = np.asarray(jsb.fused_swin_block_pair(
        xj, _jax_names(pa), jnp.asarray(ba), _jax_names(pb),
        jnp.asarray(bb), heads=NH, interpret=True, compute_dtype=jdt),
        np.float32)
    chain_j = np.asarray(jblock(jblock(xj, pa, ba), pb, bb), np.float32)
    assert (pair_j != chain_j).mean() > 0.05
    # and the port's pair is closer to the JAX pair than to a chain
    assert (np.abs(out_p.numpy() - pair_j).mean()
            < np.abs(out_c.numpy() - pair_j).mean())


def _emulate_pair(x, dout, bias_a, idx_a, la, bias_b, idx_b, lb):
    """What csrc/swin_block_pair_fwd.cu and csrc/swin_block_pair_bwd.cu
    compute, in PyTorch: per patch, block A over its windows (index
    table idx_a) into an f32 scratch, block B over its own windows
    (idx_b) from that scratch; then B's recompute and backward per
    window from dout into a second f32 scratch, and A's from x and that
    scratch, both with the pair's rounding set; the reductions sum each
    block's window terms. Returns (out, dx, A's grads (padded layout),
    A's dbias, B's grads, B's dbias)."""
    mid = torch.empty(x.shape)
    dmid = torch.empty(x.shape)
    out, dx = torch.empty_like(x), torch.empty_like(x)
    acc_a, acc_b = EmuGrads(la, bias_a), EmuGrads(lb, bias_b)
    idx_a, idx_b = idx_a.long(), idx_b.long()
    for b in range(x.shape[0]):
        for tok in idx_a:          # K3 / K4 phase a: A's f32 output
            mid[b, tok] = emu_window_fwd(la, x[b, tok].float(), bias_a,
                                         tok)[0]
        for tok in idx_b:          # K3: B from the f32 scratch
            out[b, tok] = emu_window_fwd(lb, mid[b, tok], bias_b,
                                         tok)[0].to(x.dtype)
        for tok in idx_b:          # K4 phase b: B's backward, f32 dx
            _, sv = emu_window_fwd(lb, mid[b, tok], bias_b, tok)
            d, terms, ds = emu_window_bwd(lb, dout[b, tok].float(), sv,
                                          bias_b, tok, pair_rounding=True)
            dmid[b, tok] = d
            acc_b.add(terms, ds, tok)
        for tok in idx_a:          # K4 phase c: A's backward from it
            _, sv = emu_window_fwd(la, x[b, tok].float(), bias_a, tok)
            d, terms, ds = emu_window_bwd(la, dmid[b, tok], sv, bias_a,
                                          tok, pair_rounding=True)
            dx[b, tok] = d.to(x.dtype)
            acc_a.add(terms, ds, tok)
    return (out, dx) + acc_a.result() + acc_b.result()


@pytest.mark.parametrize('dt', sorted(DTYPES))
@pytest.mark.parametrize('h,w', [(16, 16), (8, 16)])
def test_pair_kernel_design_matches_plain(dt, h, w):
    """The pair kernels' design (one patch at a time: A over shift-0
    windows into an f32 scratch, B over shift-4 windows from it; B's
    backward into a second f32 scratch, then A's; hd 10 -> 16 / C 40 ->
    48 / MLP 80 zero pads, transposed weights, per-window grad terms
    summed, each block's ds summed into its dbias) computes the plain
    versions' function: to 1e-5 of each tensor's scale in f32, within
    the bf16 grad rule in bf16 (where a different sum order may flip a
    rounding). Each dbias is exactly zero off its window blocks."""
    c, ch, ws = 40, 80, tsb.WINDOW
    tdt = DTYPES[dt][1]
    x, dout, ba, bb = _pair_inputs(13, b=2, h=h, w=w, c=c, ws=ws)
    x, dout = torch.from_numpy(x).to(tdt), torch.from_numpy(dout).to(tdt)
    ba, bb = torch.from_numpy(ba), torch.from_numpy(bb)
    pa, pb = _torch(_params(14, c, ch)), _torch(_params(15, c, ch))
    lay = [emu_layout(tsb.pack_block_params(p, NH, tdt),
                      tsb.pack_block_bwd_params(p, NH, tdt), NH, c, ch, tdt)
           for p in (pa, pb)]
    idx = [torch.from_numpy(tsb.window_index(h, w, ws, s))
           for s in (0, ws // 2)]
    out, dx, gpa, dba, gpb, dbb = _emulate_pair(x, dout, ba, idx[0], lay[0],
                                                bb, idx[1], lay[1])
    ref = tsb.swin_block_pair_ref(x, pa, ba, pb, bb, heads=NH,
                                  compute_dtype=tdt)
    dx_r, ga_r, dba_r, gb_r, dbb_r = tsb.swin_block_pair_bwd_ref(
        x, dout, pa, ba, pb, bb, heads=NH, compute_dtype=tdt)
    ga = tsb.unpack_block_grads(gpa, NH, c, ch)
    gb = tsb.unpack_block_grads(gpb, NH, c, ch)
    pairs = [('out', out, ref), ('dx', dx, dx_r), ('dbias_a', dba, dba_r),
             ('dbias_b', dbb, dbb_r)] + [
        (f'{k}_a', ga[k], ga_r[k]) for k in KEYS] + [
        (f'{k}_b', gb[k], gb_r[k]) for k in KEYS]
    for name, a, b in pairs:
        a, b = a.float(), b.float()
        if dt == 'f32':
            err = (a - b).abs().max().item()
            assert err <= 1e-5 * max(1.0, b.abs().max().item()), (name, err)
        else:
            l2 = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            assert l2 <= GRAD_L2_BF16, (name, l2)
    for s, db in ((0, dba), (ws // 2, dbb)):
        mask, _ = tsb.full_attn_mask_and_index(h, w, ws, s)
        assert (db[:, torch.from_numpy(mask != 0)] == 0).all()


def test_pair_wrapper_launches_or_raises():
    """On a non-CPU tensor the pair launches K3 or raises; the checks
    that need no card run here through a meta tensor."""
    x = torch.empty(2, 256, C, device='meta')
    p = _torch(_params(0))
    bias = torch.empty(NH, 256, 256)
    wins = ((16, 16, tsb.WINDOW, 0), (16, 16, tsb.WINDOW, tsb.WINDOW // 2))
    with pytest.raises(ValueError, match='device'):
        tsb.fused_swin_block_pair(x, p, bias, p, bias, heads=NH,
                                  windows=wins, compute_dtype=torch.float32)
    pk = tsb.pack_block_params(p, NH, torch.float32)
    idx = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match='device'):
        tsb.swin_block_pair_fwd(x, bias, idx, pk, bias, idx, pk, heads=NH,
                                compute_dtype=torch.float32)
