"""Port SwinIR (srcaco2_tpu_torch/models) against the JAX SwinIR with
fused blocks: weights go JAX -> numpy -> bridge.flax_to_torch, inputs
come from a numpy seed, and both run in f32 (f32 softmax pinned). On the
CPU the port's tiled path runs the grouped block's plain version, the
JAX one the Pallas kernel in interpret mode."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.data.pipeline import dihedral as j_dihedral
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import test_modes as JTM
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.data.transforms import dihedral as t_dihedral
from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import test_modes as TTM


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


def _pair(kw, seed=0):
    """(JAX module, its params as numpy, port module with them)."""
    jm = JSwinIR(in_chans=1, mlp_ratio=2.0, fused_blocks=True,
                 fused_mode='interpret', **kw)
    # the param tree is the same on every path: init on a small input
    # through the windowed path, which compiles fastest
    init = JSwinIR(in_chans=1, mlp_ratio=2.0, fused_blocks=True,
                   fused_mode='never', **kw)
    ws = kw['window_size']
    p = jax.jit(lambda k: init.init(k, jnp.zeros((1, 1, ws, ws)),
                                    train=False)['params'])(
        jax.random.key(seed))
    pn = jax.tree.map(np.asarray, p)
    tm = TSwinIR(in_chans=1, mlp_ratio=2.0, device='cpu', **kw)
    tm.load_state_dict(flax_to_torch(pn, tm))
    return jm, pn, tm.eval()


def _compare(kw, hw, atol, b=1):
    jm, pn, tm = _pair(kw)
    x = np.random.default_rng(1).uniform(0, 1, (b, 1, *hw)).astype(
        np.float32)
    yj = np.asarray(jax.jit(lambda t: jm.apply(
        {'params': pn}, t, train=False)['out'])(jnp.asarray(x)))
    with torch.no_grad():
        yt = tm(torch.from_numpy(x)).numpy()
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, atol=atol)


@pytest.mark.parametrize('upsampler,resi', [('pixelshuffledirect', '1conv'),
                                            ('pixelshuffle', '3conv')])
def test_small_swinir_matches_jax(upsampler, resi):
    # 24x16 LR = 384 tokens, tileable by 8-pixel tiles: the tiled path
    _compare(dict(upscale=2, window_size=4, embed_dim=16, depths=(2, 2),
                  num_heads=(2, 2), upsampler=upsampler,
                  resi_connection=resi), (24, 16), atol=1e-4)


def test_flagship_widths_swinir_matches_jax():
    """Flagship widths (C=180, 6 heads, ws 8, x8, pixelshuffledirect),
    depth cut to one stage of 2 blocks, 32x32 LR (4 tiles of 256)."""
    _compare(dict(upscale=8, window_size=8, embed_dim=180, depths=(2,),
                  num_heads=(6,), upsampler='pixelshuffledirect'),
             (32, 32), atol=2e-4)


@pytest.mark.parametrize('hw', [(24, 16), (8, 48), (16, 12)])
def test_port_tiled_matches_windowed(hw):
    """The port's two CPU paths agree; (8, 48) has one tile row, where
    the shift wraps inside each tile; (16, 12) is not tileable and takes
    the windowed path either way."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(0, 1, (2, *hw, 24)).astype(np.float32))
    m = FusedBlockStack(24, 4, 4, 4, 2.0, device='cpu')
    m.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        yt = m(x)
        yw = m._windowed_path(x)
    np.testing.assert_allclose(yt.numpy(), yw.numpy(), atol=5e-6)


def test_dihedral_matches_jax():
    img = np.random.default_rng(2).normal(0, 1, (6, 6, 2)).astype(
        np.float32)
    for m in range(8):
        np.testing.assert_array_equal(
            t_dihedral(torch.from_numpy(img), m).numpy(),
            np.asarray(j_dihedral(jnp.asarray(img), jnp.int32(m))))


_TINY = dict(upscale=2, window_size=4, embed_dim=8, depths=(2,),
             num_heads=(2,), upsampler='pixelshuffledirect')


@pytest.fixture(scope='module')
def tiny():
    return _pair(_TINY)


@pytest.mark.parametrize('mode', range(5))
def test_test_modes_match_jax(mode, tiny):
    """Modes 0-4 (normal, pad, split, x8, split+x8) around the same
    small net; refield/min_size/modulo are shrunk so split and pad act
    on a 16x16 input (pads to 24x24 take the tiled path)."""
    _, pn, tm = tiny
    jw = JSwinIR(in_chans=1, mlp_ratio=2.0, fused_blocks=True,
                 fused_mode='never', **_TINY)
    opts = dict(mode=mode, refield=4, min_size=8, sf=2, modulo=12)
    x = np.random.default_rng(3).uniform(0, 1, (2, 1, 16, 16)).astype(
        np.float32)
    yj = np.asarray(jax.jit(lambda t: JTM.test_mode(
        lambda u: jw.apply({'params': pn}, u, train=False)['out'], t,
        **opts))(jnp.asarray(x)))
    with torch.no_grad():
        yt = TTM.test_mode(tm, torch.from_numpy(x), **opts).numpy()
    assert yt.shape == yj.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(yt, yj, atol=1e-4)


def test_bridge_rejects_unmapped_and_unused_leaves(tiny):
    _, pn, tm = tiny
    extra = dict(pn, bogus={'kernel': np.zeros((3, 3, 1, 1), np.float32)})
    with pytest.raises(KeyError, match='unmapped flax param bogus'):
        flax_to_torch(extra, tm)
    short = {k: v for k, v in pn.items() if k != 'LayerNorm_0'}
    with pytest.raises(KeyError, match='norm.weight'):
        flax_to_torch(short, tm)
    bad = dict(pn, patch_norm={'scale': np.zeros(9, np.float32),
                               'bias': pn['patch_norm']['bias']})
    with pytest.raises(ValueError, match='patch_norm.weight'):
        flax_to_torch(bad, tm)
