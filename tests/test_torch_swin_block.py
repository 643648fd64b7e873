"""Port of the grouped fused Swin block (srcaco2_tpu_torch/ops/swin_block.py)
against the JAX package: bias constants and tile layouts exactly, the
plain PyTorch version against the Pallas kernel run in interpret mode,
and the CUDA kernel's padded per-window weight layout (emulated in
PyTorch) against the plain version."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.models import swin_fused as jsf
from srcaco2_tpu.ops.pallas import swin_block as jsb
from srcaco2_tpu_torch.models import swin_fused as tsf
from srcaco2_tpu_torch.ops import swin_block as tsb

# tests/test_swin_fused.py:19 widths
C, NH, WS = 24, 4, 4
DTYPES = {'f32': (jnp.float32, torch.float32, 2e-5),
          # bf16 rounding of activations and weights: ~3 significant
          # digits on O(1) block outputs
          'bf16': (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _params(seed, c=C, ch=2 * C):
    r = np.random.default_rng(seed)

    def g(*s):
        return r.normal(0, 0.1, s).astype(np.float32)
    return {
        'ln1_scale': 1.0 + g(c), 'ln1_bias': g(c),
        'qkv_kernel': g(c, 3 * c), 'qkv_bias': g(3 * c),
        'proj_kernel': g(c, c), 'proj_bias': g(c),
        'ln2_scale': 1.0 + g(c), 'ln2_bias': g(c),
        'mlp1_kernel': g(c, ch), 'mlp1_bias': g(ch),
        'mlp2_kernel': g(ch, c), 'mlp2_bias': g(c),
    }


def _torch_params(p):
    return {k.replace('_scale', '_weight'): torch.from_numpy(v)
            for k, v in p.items()}


@pytest.mark.parametrize('h,w,ws,shift', [(8, 12, 4, 0), (8, 12, 4, 2),
                                          (16, 16, 8, 4), (24, 16, 4, 2)])
def test_bias_constants_match_jax(h, w, ws, shift):
    m_t, r_t = tsb.full_attn_mask_and_index(h, w, ws, shift)
    m_j, r_j = jsb.full_attn_mask_and_index(h, w, ws, shift)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(tsf._tile_group_masks(ws, shift),
                                  jsf._tile_group_masks(ws, shift))
    tables = np.random.default_rng(3).normal(
        0, 1, (3, (2 * ws - 1) ** 2, NH)).astype(np.float32)
    np.testing.assert_array_equal(
        tsb.build_attn_bias(torch.from_numpy(tables), h, w, ws).numpy(),
        np.asarray(jsb.build_attn_bias(jnp.asarray(tables), h, w, ws)))
    if h % (2 * ws) == 0 and w % (2 * ws) == 0:
        lt = tsf._tile_layout(2, h, w, ws, shift)
        lj = jsf._tile_layout(2, h, w, ws, shift, 512)
        np.testing.assert_array_equal(lt.perm, lj.perm)
        np.testing.assert_array_equal(lt.inv, lj.inv)
        # the port keeps one group id per tile, the TPU one per program
        np.testing.assert_array_equal(lt.gid, np.repeat(lj.gid, lj.ib))


def _grouped_inputs(b=2, h=16, w=24, ws=WS, c=C, nh=NH, seed=0):
    """Tiles, group table and per-tile groups of the shifted layout."""
    r = np.random.default_rng(seed)
    tl = 2 * ws
    t = tl * tl
    n_tiles = b * (h // tl) * (w // tl)
    x = r.normal(0, 1, (n_tiles, t, c)).astype(np.float32)
    table = r.normal(0, 0.02, (1, (2 * ws - 1) ** 2, nh)).astype(np.float32)
    rel = jsb.build_attn_bias(jnp.asarray(table), tl, tl, ws, shifts=(0,))
    groups = np.array(rel[0][None]
                      + jsf._tile_group_masks(ws, ws // 2)[:, None])
    return x, groups, jsf._tile_layout(b, h, w, ws, ws // 2, 512)


@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_grouped_ref_matches_jax_kernel(dt, monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')
    jdt, tdt, atol = DTYPES[dt]
    x, groups, lay = _grouped_inputs()
    p = _params(1)
    out_j = jsb.fused_swin_block_grouped(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(groups), jnp.asarray(lay.gid), heads=NH, ib=lay.ib,
        interpret=True, compute_dtype=jdt)
    gid = torch.from_numpy(np.repeat(lay.gid, lay.ib))
    out_t = tsb.swin_block_grouped_ref(
        torch.from_numpy(x), _torch_params(p), torch.from_numpy(groups),
        gid, heads=NH, compute_dtype=tdt)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=atol)
    # the wrapper on a CPU tensor is the plain version and launches
    # nothing
    before = tsb.fused_swin_block_grouped.launches
    out_w = tsb.fused_swin_block_grouped(
        torch.from_numpy(x), _torch_params(p), torch.from_numpy(groups),
        gid, heads=NH, compute_dtype=tdt)
    assert torch.equal(out_w, out_t)
    assert tsb.fused_swin_block_grouped.launches == before


def _emulate_kernel(x, pk, groups, gid, heads, c, ch, cdt):
    """What csrc/swin_block_grouped.cu computes, in PyTorch: per 64-token
    window, products `act @ W^T` on the packed, zero-padded layout, the
    window's slice of its tile's group bias, and the kernel's rounding
    points."""
    ws, tl = tsb.WINDOW, 2 * tsb.WINDOW
    hd = c // heads
    hp, ck = -(-hd // 16) * 16, -(-c // 16) * 16
    f = {k: v.float() for k, v in pk._asdict().items()}

    def rnd(v):
        return v.to(cdt).float()

    r = torch.arange(ws * ws)
    wins = [((w >> 1) * ws + r // ws) * tl + (w & 1) * ws + r % ws
            for w in range(4)]
    out = torch.empty_like(x)
    for tile in range(x.shape[0]):
        g = int(gid[tile])
        for tok in wins:
            xw = x[tile, tok].float()
            y = torch.zeros(len(tok), ck)
            y[:, :c] = rnd(tsb._ln(xw, f['g1'], f['b1']))
            o = torch.zeros(len(tok), heads * hp)
            for h in range(heads):
                qkv = rnd(rnd(y @ f['wqkv'][h].reshape(3 * hp, ck).T)
                          + f['bqkv'][h].reshape(3 * hp))
                q, k, v = qkv[:, :hp], qkv[:, hp:2 * hp], qkv[:, 2 * hp:]
                s = q @ k.T + groups[g, h][tok][:, tok]
                e = torch.exp(s - s.amax(-1, keepdim=True))
                o[:, h * hp:(h + 1) * hp] = rnd(
                    (rnd(e) @ v) * (1.0 / e.sum(-1, keepdim=True)))
            x2 = xw + ((o @ f['wproj'].T)[:, :c] + f['bproj'])
            y2 = torch.zeros(len(tok), ck)
            y2[:, :c] = rnd(tsb._ln(x2, f['g2'], f['b2']))
            u = rnd(rnd(y2 @ f['w1'].T) + f['bm1'])
            hid = tsb._gelu(u.to(cdt)).float()
            out[tile, tok] = (x2 + ((hid @ f['w2'].T)[:, :c]
                                    + f['bm2'])).to(x.dtype)
    return out


@pytest.mark.parametrize('dt', sorted(DTYPES))
def test_kernel_layout_emulation_matches_ref(dt):
    """The kernel's design (64-token windows cut out of 256-token tiles,
    hd 10 -> 16 / C 40 -> 48 / MLP 80 zero pads, transposed weights)
    computes the plain version's function."""
    _, tdt, atol = DTYPES[dt]
    c, nh, ch = 40, 4, 80
    x, groups, lay = _grouped_inputs(b=1, h=32, w=32, ws=tsb.WINDOW, c=c,
                                     nh=nh)
    p = _torch_params(_params(2, c, ch))
    xt = torch.from_numpy(x).to(tdt)
    gid = torch.from_numpy(np.repeat(lay.gid, lay.ib))
    groups = torch.from_numpy(groups)
    ref = tsb.swin_block_grouped_ref(xt, p, groups, gid, heads=nh,
                                     compute_dtype=tdt)
    emu = _emulate_kernel(xt, tsb.pack_block_params(p, nh, tdt), groups,
                          gid, nh, c, ch, tdt)
    np.testing.assert_allclose(emu.float().numpy(), ref.float().numpy(),
                               atol=atol if dt == 'bf16' else 1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """On a CUDA tensor the wrapper launches or raises; the checks that
    need no card run here through a meta tensor."""
    x = torch.empty(4, 256, C, device='meta')
    with pytest.raises(ValueError, match='device'):
        tsb.fused_swin_block_grouped(
            x, _torch_params(_params(0)), torch.empty(4, NH, 256, 256),
            torch.zeros(4, dtype=torch.int32), heads=NH)
