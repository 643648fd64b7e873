"""The fused Swin block with its backward (srcaco2_tpu_torch/ops/swin_block.py,
K1 + K2) against the JAX package: the plain PyTorch versions and the
autograd Function against the Pallas kernel and its custom VJP run in
interpret mode, and the CUDA kernels' per-window design (window index
table, padded weight layouts, per-token workspace, reductions) emulated
in PyTorch against the plain versions. The CUDA kernels themselves run
only on the card (chip_smoke.py holds them against the plain versions
there)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.ops.pallas import swin_block as jsb
from srcaco2_tpu_torch.ops import swin_block as tsb

# tests/test_swin_fused.py:19 widths
B, H, W, C, NH, WS = 2, 8, 8, 24, 4, 4
CH = 2 * C
KEYS = tsb.BLOCK_KEYS
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}
# forward: f32 only sum order differs; bf16 rounds activations and
# weights to ~3 significant digits
FWD_TOL = {'f32': 2e-5, 'bf16': 2e-2}
# grads: f32 max abs <= 1e-4 max|ref| + 1e-6; bf16 relative L2 per tensor
GRAD_RTOL_F32, GRAD_L2_BF16 = 1e-4, 3e-2


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


def _params(seed, c=C, ch=CH):
    r = np.random.default_rng(seed)

    def g(*s):
        return r.normal(0, 0.1, s).astype(np.float32)
    return {
        'ln1_weight': 1.0 + g(c), 'ln1_bias': g(c),
        'qkv_kernel': g(c, 3 * c), 'qkv_bias': g(3 * c),
        'proj_kernel': g(c, c), 'proj_bias': g(c),
        'ln2_weight': 1.0 + g(c), 'ln2_bias': g(c),
        'mlp1_kernel': g(c, ch), 'mlp1_bias': g(ch),
        'mlp2_kernel': g(ch, c), 'mlp2_bias': g(c),
    }


def _jax_names(p):
    return {k.replace('_weight', '_scale'): jnp.asarray(v)
            for k, v in p.items()}


def _inputs(seed, b=B, h=H, w=W, c=C, ws=WS, shift=0):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h * w, c)).astype(np.float32)
    dout = r.normal(0, 1, (b, h * w, c)).astype(np.float32)
    table = r.normal(0, 0.02, (1, (2 * ws - 1) ** 2, NH)).astype(np.float32)
    bias = tsb.build_attn_bias(torch.from_numpy(table), h, w, ws,
                               shifts=(shift,))[0]
    return x, dout, bias.numpy()


@functools.lru_cache(maxsize=None)
def _jax_vjp(cdt_name):
    jdt = DTYPES[cdt_name][0]

    def f(x, params, bias, dout):
        out, vjp = jax.vjp(
            lambda xx, pp, bb: jsb.fused_swin_block(
                xx, pp, bb, heads=NH, interpret=True, compute_dtype=jdt),
            x, params, bias)
        return out, vjp(dout)
    return jax.jit(f)


def _close(name, got, ref, dt):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    if dt == 'f32':
        lim = GRAD_RTOL_F32 * np.abs(ref).max() + 1e-6
        assert np.abs(got - ref).max() <= lim, (name, np.abs(got - ref).max(),
                                                lim)
    else:
        l2 = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert l2 <= GRAD_L2_BF16, (name, l2)


@pytest.mark.parametrize('dt', sorted(DTYPES))
@pytest.mark.parametrize('shift', [0, WS // 2])
def test_plain_block_and_grads_match_jax_kernel(dt, shift):
    """K1's and K2's plain versions, through the autograd Function on
    CPU tensors, against fused_swin_block's forward and custom VJP in
    interpret mode: the output, dx, the 12 weight grads and dbias."""
    jdt, tdt = DTYPES[dt]
    x, dout, bias = _inputs(3, shift=shift)
    p = _params(4)
    out_j, (dx_j, dp_j, db_j) = _jax_vjp(dt)(
        jnp.asarray(x, jdt), _jax_names(p), jnp.asarray(bias),
        jnp.asarray(dout, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    bt = torch.from_numpy(bias).requires_grad_()
    before = (tsb.swin_block_fwd.launches, tsb.swin_block_bwd.launches)
    out_t = tsb.fused_swin_block(xt, pt, bt, heads=NH,
                                 window=(H, W, WS, shift),
                                 compute_dtype=tdt)
    out_t.backward(torch.from_numpy(dout).to(tdt))
    # CPU tensors run the plain versions and launch nothing
    assert (tsb.swin_block_fwd.launches,
            tsb.swin_block_bwd.launches) == before
    fwd_err = np.abs(out_t.detach().float().numpy()
                     - np.asarray(out_j, np.float32)).max()
    assert fwd_err <= FWD_TOL[dt], fwd_err
    assert xt.grad.dtype == tdt
    _close('dx', xt.grad.float(), dx_j, dt)
    _close('dbias', bt.grad, db_j, dt)
    for k in KEYS:
        _close(k, pt[k].grad, dp_j[k.replace('_weight', '_scale')], dt)


def _rnd(v, cdt):
    return v.to(cdt).float()


def _ln(z):
    mu = z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((z - mu) ** 2).mean(-1, keepdim=True) + tsb.LN_EPS)
    return (z - mu) * rstd, rstd


def _ln_bwd(dy, g_, xh, rstd):
    dxh = dy * g_
    return (dxh - dxh.mean(-1, keepdim=True)
            - xh * (dxh * xh).mean(-1, keepdim=True)) * rstd


def _pad(z, n):
    return torch.nn.functional.pad(z, (0, n - z.shape[-1]))


def emu_layout(pk, pb, heads, c, ch, cdt):
    """One block's packed, zero-padded weights (as f32) and widths, as
    the kernels see them."""
    pd = tsb._pads(c, heads, ch)
    return dict(hp=pd.hp, ck=pd.ck, ca=heads * pd.hp, chp=pd.chp, c=c,
                ch=ch, heads=heads, cdt=cdt,
                f={k: v.float() for k, v in pk._asdict().items()},
                fb={k: v.float() for k, v in pb._asdict().items()})


def emu_window_fwd(L, xw, bias, tok):
    """The block body of csrc/swin_block_common.cuh over one 64-token
    window: f32 rows xw of the window whose raster tokens are tok, the
    window's 64x64 slice of the bias, products `act @ W^T` on the packed
    layouts, the kernels' rounding points. Returns (the block output
    rows in f32, unrounded; the saved per-token operands)."""
    f, cdt, heads = L['f'], L['cdt'], L['heads']
    hp, ck, ca, c = L['hp'], L['ck'], L['ca'], L['c']
    xh1, rstd1 = _ln(xw)
    y = _pad(_rnd(xh1 * f['g1'] + f['b1'], cdt), ck)
    o = torch.zeros(64, ca)
    qkv = torch.zeros(64, 3 * ca)
    for h in range(heads):
        z = _rnd(_rnd(y @ f['wqkv'][h].reshape(3 * hp, ck).T, cdt)
                 + f['bqkv'][h].reshape(3 * hp), cdt)
        q, k, v = z[:, :hp], z[:, hp:2 * hp], z[:, 2 * hp:]
        for part, val in enumerate((q, k, v)):
            qkv[:, (part * heads + h) * hp:
                (part * heads + h + 1) * hp] = val
        s = q @ k.T + bias[h][tok][:, tok]
        e = torch.exp(s - s.amax(-1, keepdim=True))
        o[:, h * hp:(h + 1) * hp] = _rnd(
            (_rnd(e, cdt) @ v) * (1.0 / e.sum(-1, keepdim=True)), cdt)
    x2 = xw + ((o @ f['wproj'].T)[:, :c] + f['bproj'])
    xh2, rstd2 = _ln(x2)
    y2 = _pad(_rnd(xh2 * f['g2'] + f['b2'], cdt), ck)
    u = _rnd(_rnd(y2 @ f['w1'].T, cdt) + f['bm1'], cdt)
    hact = tsb._gelu(u.to(cdt)).float()
    out = x2 + ((hact @ f['w2'].T)[:, :c] + f['bm2'])
    return out, dict(xh1=xh1, rstd1=rstd1, y=y, qkv=qkv, o=o, xh2=xh2,
                     rstd2=rstd2, y2=y2, u=u, hact=hact)


def emu_window_bwd(L, g, sv, bias, tok, pair_rounding):
    """The window backward of csrc/swin_block_bwd_common.cuh from the f32
    incoming grad rows g (unrounded in dbm2 and dx2, rounded in the
    products) and emu_window_fwd's operands, with K2's rounding set or,
    with pair_rounding, the pair's (_block_bwd_math's). Returns (dx rows
    in f32, the window's terms of every weight grad sum, ds (heads, 64,
    64))."""
    f, fb, cdt, heads = L['f'], L['fb'], L['cdt'], L['heads']
    hp, ck, ca, c, ch = L['hp'], L['ck'], L['ca'], L['c'], L['ch']
    g = _pad(g, ck)
    gt = _rnd(g, cdt)
    u = sv['u'].to(cdt)
    du = (gt @ fb['w2_t'].T) * tsb._gelu_grad(u, tsb._gelu_tanh(u)).float()
    du_c = _rnd(du, cdt)
    dy2 = (du_c @ fb['w1_t'].T)[:, :c]
    dx2 = g[:, :c] + _ln_bwd(dy2, f['g2'], sv['xh2'], sv['rstd2'])
    dx2_c = _pad(_rnd(dx2, cdt), ck)
    do = _rnd(dx2_c @ fb['wproj_t'].T, cdt)
    dqkv = torch.zeros(64, 3 * ca)
    ds_all = torch.zeros(heads, 64, 64)
    for h in range(heads):
        def blk(part):
            lo = (part * heads + h) * hp
            return slice(lo, lo + hp)
        qkv = sv['qkv']
        q, k, v = qkv[:, blk(0)], qkv[:, blk(1)], qkv[:, blk(2)]
        doh = do[:, h * hp:(h + 1) * hp]
        s = q @ k.T + bias[h][tok][:, tok]
        e = torch.exp(s - s.amax(-1, keepdim=True))
        inv = 1.0 / e.sum(-1, keepdim=True)
        pr = e * (inv if pair_rounding else _rnd(inv, cdt))
        dp = doh @ v.T
        dqkv[:, blk(2)] = _rnd(_rnd(pr, cdt).T @ doh, cdt)
        if pair_rounding:
            ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
        else:
            dp = _rnd(dp, cdt)
            rs = _rnd((dp * pr).sum(-1, keepdim=True), cdt)
            ds = pr * _rnd(dp - rs, cdt)
        ds_all[h] = ds
        dqkv[:, blk(0)] = _rnd(_rnd(ds, cdt) @ k, cdt)
        dqkv[:, blk(1)] = _rnd(_rnd(ds, cdt).T @ q, cdt)
    dy = (dqkv @ fb['wqkv_t'].T)[:, :c]
    dx = dx2 + _ln_bwd(dy, f['g1'], sv['xh1'], sv['rstd1'])
    ones = torch.ones(64, 1)
    terms = dict(
        dwqkv=torch.cat([sv['y'][:, :c], ones], 1).T @ dqkv,
        dwproj=sv['o'].T @ dx2_c[:, :c], dw1=sv['y2'][:, :c].T @ du_c[:, :ch],
        dw2=sv['hact'][:, :ch].T @ gt[:, :c], dbm2=g[:, :c].sum(0),
        dbm1=du.sum(0), dg2=(dy2 * sv['xh2']).sum(0), db2=dy2.sum(0),
        dbproj=dx2.sum(0), dg1=(dy * sv['xh1']).sum(0), db1=dy.sum(0))
    return dx, terms, ds_all


# windows per token split of the reduction's weight products (SPLIT_ROWS
# = 2048 tokens) and per chunk of its column sums (CS_ROWS = 256 rows of
# per-16-token partials), swin_block_bwd_common.cuh
SPLIT_WINDOWS, CS_WINDOWS = 2048 // 64, 256 // 4
WEIGHT_TERMS = ('dwqkv', 'dwproj', 'dw1', 'dw2')


class EmuGrads:
    """The reduction pass: every window's terms summed into the weight
    grads (in the kernels' padded layout) and ds into dbias, in the
    reduction's order: per token split (weight products) or chunk
    (column sums) in window order, then the splits or chunks in order."""

    def __init__(self, L, bias):
        c, ca = L['c'], L['ca']
        self.c = c
        self.zeros = dict(dwqkv=(c + 1, 3 * ca), dwproj=(ca, c),
                          dw1=(c, L['ch']), dw2=(L['ch'], c),
                          dbm1=(L['chp'],), **{k: (c,) for k in (
                              'dg1', 'db1', 'dg2', 'db2', 'dbproj', 'dbm2')})
        self.parts = {k: [] for k in self.zeros}
        self.n = 0
        self.dbias = torch.zeros_like(bias)

    def add(self, terms, ds, tok):
        for k, v in terms.items():
            per = SPLIT_WINDOWS if k in WEIGHT_TERMS else CS_WINDOWS
            if self.n % per == 0:
                self.parts[k].append(torch.zeros(self.zeros[k]))
            self.parts[k][-1] += v
        self.n += 1
        for h in range(ds.shape[0]):
            self.dbias[h][tok[:, None], tok[None, :]] += ds[h]

    def result(self):
        gp = {}
        for k, parts in self.parts.items():
            gp[k] = torch.zeros(self.zeros[k])
            for part in parts:
                gp[k] += part
        gp['dbqkv'] = gp['dwqkv'][self.c]
        gp['dwqkv'] = gp['dwqkv'][:self.c]
        return gp, self.dbias


def _emulate_kernels(x, dout, bias, idx, pk, pb, heads, c, ch, cdt):
    """What csrc/swin_block_fwd.cu and csrc/swin_block_bwd.cu compute, in
    PyTorch: per 64-token window read through the window index table,
    products `act @ W^T` on the packed, zero-padded layouts, the
    window's 64x64 slice of the bias, the kernels' rounding points; the
    weight grads as sums over every window of the per-token operands,
    the bias grad as the windows' ds summed over patches. Returns
    (out, dx, grads in the kernels' padded layout, dbias)."""
    L = emu_layout(pk, pb, heads, c, ch, cdt)
    out, dx = torch.empty_like(x), torch.empty_like(x)
    acc = EmuGrads(L, bias)
    for b in range(x.shape[0]):
        for tok in idx.long():
            o, sv = emu_window_fwd(L, x[b, tok].float(), bias, tok)
            out[b, tok] = o.to(x.dtype)
            d, terms, ds = emu_window_bwd(L, dout[b, tok].float(), sv, bias,
                                          tok, pair_rounding=False)
            dx[b, tok] = d.to(x.dtype)
            acc.add(terms, ds, tok)
    return (out, dx) + acc.result()


@pytest.mark.parametrize('h,w,shift', [(16, 16, 0), (16, 16, 4),
                                       (8, 16, 4)])
def test_kernel_window_design_matches_plain(h, w, shift):
    """The kernels' design (64-token windows read through the window
    index table with the cyclic shift, hd 10 -> 16 / C 40 -> 48 / MLP
    80 zero pads, transposed weights, per-token operands summed into the
    weight grads, the windows' ds summed into dbias) computes the plain
    versions' function in f32; dbias is exactly zero off the window
    blocks."""
    c, ch = 40, 80
    x, dout, bias = _inputs(5, b=2, h=h, w=w, c=c, ws=tsb.WINDOW,
                            shift=shift)
    x, dout, bias = map(torch.from_numpy, (x, dout, bias))
    p = {k: torch.from_numpy(v) for k, v in _params(6, c, ch).items()}
    cdt = torch.float32
    idx = torch.from_numpy(tsb.window_index(h, w, tsb.WINDOW, shift))
    out, dx, gp, dbias = _emulate_kernels(
        x, dout, bias, idx, tsb.pack_block_params(p, NH, cdt),
        tsb.pack_block_bwd_params(p, NH, cdt), NH, c, ch, cdt)
    grads = tsb.unpack_block_grads(gp, NH, c, ch)
    ref = tsb.swin_block_ref(x, p, bias, heads=NH, compute_dtype=cdt)
    dx_r, g_r, db_r = tsb.swin_block_bwd_ref(x, dout, p, bias, heads=NH,
                                             compute_dtype=cdt)
    for name, a, b in [('out', out, ref), ('dx', dx, dx_r),
                       ('dbias', dbias, db_r)] + [
            (k, grads[k], g_r[k]) for k in KEYS]:
        # 1e-5 of each tensor's scale: the weight grads sum ~500 tokens
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * max(1.0, b.abs().max().item()), (name, err)
    mask, _ = tsb.full_attn_mask_and_index(h, w, tsb.WINDOW, shift)
    assert (dbias[:, torch.from_numpy(mask != 0)] == 0).all()


def test_window_index_is_the_bias_window_partition():
    """Every window of the index table is one block of the bias mask:
    tokens of a window may attend to each other (up to the shift's
    regions), tokens of different windows never do."""
    for h, w, shift in [(16, 16, 0), (16, 16, 4), (8, 16, 4), (8, 8, 0)]:
        idx = tsb.window_index(h, w, tsb.WINDOW, shift)
        mask, _ = tsb.full_attn_mask_and_index(h, w, tsb.WINDOW, shift)
        assert sorted(idx.ravel()) == list(range(h * w))
        win = np.empty(h * w, int)
        for wi, row in enumerate(idx):
            win[row] = wi
        same = win[:, None] == win[None, :]
        assert (mask[~same] != 0).all()
        assert (np.diag(mask) == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    """On a CUDA tensor the wrappers launch or raise; the checks that
    need no card run here through meta tensors."""
    x = torch.empty(2, 256, C, device='meta')
    p = {k: torch.from_numpy(v) for k, v in _params(0).items()}
    pk = tsb.pack_block_params(p, NH, torch.float32)
    bias = torch.empty(NH, 256, 256)
    idx = torch.zeros(4, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match='device'):
        tsb.swin_block_fwd(x, bias, idx, pk, heads=NH,
                           compute_dtype=torch.float32)
    with pytest.raises(ValueError, match='window side'):
        tsb._window_table((16, 16, 4, 0), 256, 'cpu')


def test_build_target_hashes_the_headers(tmp_path, monkeypatch):
    """A kernel library's name changes with any csrc/ header, so an
    edited header never reuses a stale build."""
    from srcaco2_tpu_torch.ops import build
    src, hdr = tmp_path / 'k.cu', tmp_path / 'common.cuh'
    src.write_text('#include "common.cuh"\n')
    hdr.write_text('// a\n')
    monkeypatch.setattr(build, 'CSRC', tmp_path)
    first = build._target(src)
    assert first.name.startswith('k-') and build._target(src) == first
    hdr.write_text('// b\n')
    assert build._target(src) != first
