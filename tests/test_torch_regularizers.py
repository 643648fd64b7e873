"""The weight regularizers of the port (train/regularizers.py) against
the JAX package's regularizer_orth / regularizer_clip after bridging the
same params: SwinIR (fused; unfused, whose scanned block pairs inside
scanned stages stack their dense kernels to 4 axes), DFCAN, MSLapSRN
and DBPN (transposed convs), MemNet and ENLCN (whose buffers stay
untouched), GRL and DSR-Splines (kernels JAX stacks or vmaps to 5 axes,
which it leaves alone). Held: orth's result within 5e-5 of the kernel's
largest entry and its shrink of each kernel's singular values within
2e-6 of JAX's; clip exactly."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import regularizers as JR
from srcaco2_tpu_torch.bridge import (flax_to_torch, kernel_to_flax,
                                      orth_kernels)
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import regularizers as TR

import test_torch_zoo2_train as Z2
import test_torch_zoo3_train as Z3
import test_torch_zoo_train as Z1
from test_torch_zoo import enlcn_projection

_SWIN = dict(in_chans=1, upscale=2, window_size=4, embed_dim=16,
             depths=(2, 2), num_heads=(2, 2), mlp_ratio=2.0,
             upsampler='pixelshuffle')
NETS = {
    'SwinIR': (JSwinIR, TSwinIR, dict(_SWIN, fused_blocks=True), 2, 16),
    'SwinIR_unfused': (JSwinIR, TSwinIR, dict(_SWIN, fused_blocks=False),
                       2, 16),
    'SwinIR_2_4': (JSwinIR, TSwinIR, dict(_SWIN, fused_blocks=False,
                                          depths=(2, 4)), 2, 16),
    'DFCAN': Z1.NETS['DFCAN'], 'MSLapSRN': Z1.NETS['MSLapSRN'],
    'ENLCN': Z1.NETS['ENLCN'], 'MemNet': Z2.NETS['MemNet'],
    'GRL': Z2.NETS['GRL'], 'DBPN': Z3.NETS['DBPN'][:5],
    'DSRSplines': Z3.NETS['DSRSplines'][:5],
}


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    jcls, _, kw, scale, hs = NETS[name]
    jkw = {k: v for k, v in kw.items() if k != 'fused_blocks'}
    if 'fused_blocks' in kw:
        jkw.update(fused_blocks=kw['fused_blocks'], fused_mode='never')
    x = jnp.zeros((1, 1, hs // scale, hs // scale))
    return jax.tree.map(np.asarray, jax.jit(
        lambda k, t: jcls(**jkw).init(k, t, train=False))(
        jax.random.key(0), x))


def _pair(name, scale_params):
    """JAX params (x scale_params), and the port model holding them with
    its buffers (MemNet's statistics, ENLCN's projection)."""
    _, tcls, kw, _, _ = NETS[name]
    variables = _jax_variables(name)
    pn = jax.tree.map(lambda a: a * np.float32(scale_params),
                      variables['params'])
    tm = tcls(device='cpu', **kw)
    stats = {k: v for k, v in variables.items() if k != 'params'}
    proj = enlcn_projection(kw['n_feats']) if name == 'ENLCN' else None
    tm.load_state_dict(flax_to_torch(pn, tm, projection=proj,
                                     model_state=stats or None),
                       strict=False)
    if stats:
        with torch.no_grad():
            for b in tm.buffers():
                b.add_(0.25)     # statistics that are not 0 / 1
    return pn, tm


def _flax_leaf(params, names, kind):
    leaves = [kernel_to_flax(params[n], kind) for n in names]
    a = leaves[0] if len(leaves) == 1 else torch.stack(leaves)
    return a.detach().double().numpy().reshape(-1, a.shape[-1])


@pytest.mark.parametrize('name', sorted(NETS))
def test_orth_matches_jax(name):
    """Every parameter within 5e-5 of max|w| of JAX's result (two f32
    SVD reconstructions; MSLapSRN's bilinear transposed-conv kernels,
    rank-deficient, reach 3.5e-5), the parameters outside the 4-D
    kernels and every buffer unchanged, and each kernel's singular
    values shrunk as JAX's (those above 1.5x their mean by 1e-4; within
    2e-6 of the largest)."""
    pn, tm = _pair(name, 1.0)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    params = dict(tm.named_parameters())
    ref = flax_to_torch(jax.tree.map(np.asarray, JR.regularizer_orth(pn)),
                        tm)
    TR.regularizer_orth(tm)
    groups = orth_kernels(tm)
    touched = {n for names, _ in groups for n in names}
    for k, v in tm.state_dict().items():
        if k not in params or k not in touched:
            assert torch.equal(v, before[k]), k
            if k in ref:
                assert torch.equal(ref[k], before[k]), k
            continue
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=5e-5 * float(ref[k].abs().max()),
                                   err_msg=k)
    shrunk = 0
    for names, kind in groups:
        sv = [np.linalg.svd(_flax_leaf(p, names, kind), compute_uv=False)
              for p in (before, dict(tm.named_parameters()), ref)]
        np.testing.assert_allclose(sv[0] - sv[1], sv[0] - sv[2], rtol=0,
                                   atol=2e-6 * max(1.0, sv[0][0]),
                                   err_msg=str(names))
        shrunk += int(((sv[0] - sv[2]) > 5e-5).sum())
        assert ((sv[0] - sv[1]) > 5e-5).sum() == ((sv[0] - sv[2]) > 5e-5).sum()
    # DSR-Splines' few 4-D kernels have no singular value above 1.5x the
    # mean at this init
    assert shrunk > 0 or name == 'DSRSplines'
    if name in ('GRL', 'DSRSplines'):
        assert len(touched) < sum(p.ndim == 4 for p in tm.parameters())


@pytest.mark.parametrize('name', sorted(NETS))
def test_clip_matches_jax(name):
    """Params scaled so that many entries lie outside [-1.5, 1.5]."""
    pn, tm = _pair(name, 40.0)
    before = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    ref = flax_to_torch(jax.tree.map(np.asarray, JR.regularizer_clip(pn)),
                        tm)
    TR.regularizer_clip(dict(tm.named_parameters()))
    for k, v in tm.state_dict().items():
        if k in ref:
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(),
                                          err_msg=k)
        else:
            assert torch.equal(v, before[k]), k
    moved = sum(int((v != before[k]).sum())
                for k, v in tm.state_dict().items())
    assert moved > 0
