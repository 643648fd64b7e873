"""The port's host lattice ops against the JAX package's: the
permutohedral filter (native/, the port's own copy of the C++ source and
its ctypes binding), dense_crf_loss's value and gradient
(losses/crf.py) and permutohedral_attention (ops/pam.py), within 1e-6
relative; the build on first use, and several builds at once."""
import importlib
import subprocess
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import native as j_native
from srcaco2_tpu.losses.crf import dense_crf_loss as j_crf
from srcaco2_tpu.ops.pam import permutohedral_attention as j_pam
from srcaco2_tpu_torch import native as t_native
from srcaco2_tpu_torch.losses.crf import dense_crf_loss as t_crf
from srcaco2_tpu_torch.ops.pam import permutohedral_attention as t_pam

REL = 1e-6


def _rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, err


def _images(c, seed, n=2, h=12, w=10):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (n, c, h, w)).astype(np.float32),
            r.uniform(0, 1, (n, 3, h, w)).astype(np.float32))


@pytest.mark.parametrize('c', [1, 3])
def test_bilateral_filter_matches_jax(c):
    img, seg = _images(c, 0)
    _rel_close(t_native.bilateral_filter(img, seg, 20.0, 5.0),
               j_native.bilateral_filter(img, seg, 20.0, 5.0))


def test_batch_entry_and_generic_filter_match_jax():
    img, seg = _images(3, 1)
    n, k, h, w = seg.shape
    got = np.zeros(seg.size, np.float32)
    want = np.zeros(seg.size, np.float32)
    t_native.bilateralfilter_batch(img.ravel(), seg.ravel(), got, n, k, h,
                                   w, 15.0, 80.0)
    j_native.bilateralfilter_batch(img.ravel(), seg.ravel(), want, n, k, h,
                                   w, 15.0, 80.0)
    _rel_close(got, want)
    r = np.random.default_rng(2)
    f = r.uniform(0, 3, (50, 4)).astype(np.float32)
    v = r.uniform(0, 1, (50, 3)).astype(np.float32)
    _rel_close(t_native.permutohedral_filter(f, v),
               j_native.permutohedral_filter(f, v))
    with pytest.raises(ValueError):
        t_native.bilateral_filter(img[:, :2], seg, 1.0, 1.0)
    with pytest.raises(ValueError):
        t_native.permutohedral_filter(f, v[:10])
    with pytest.raises(ValueError):
        t_native.bilateralfilter_batch(img.ravel(), seg.ravel(),
                                       got[:-1], n, k, h, w, 1.0, 1.0)


@pytest.mark.parametrize('c', [1, 3])
def test_dense_crf_loss_matches_jax(c):
    """The loss and its gradient in the segmentations (-2 g W s / N);
    none flows to the images."""
    img, seg = _images(c, 3)
    lj, gj = jax.value_and_grad(
        lambda s: 2.0 * j_crf(jnp.asarray(img), s, 20.0, 5.0))(
        jnp.asarray(seg))
    ti = torch.from_numpy(img).requires_grad_()
    ts = torch.from_numpy(seg).requires_grad_()
    lt = t_crf(ti, ts, 20.0, 5.0)
    (2.0 * lt).backward()
    assert lt.dtype == torch.float32 and lt.shape == ()
    _rel_close(2.0 * lt.detach().numpy(), lj)
    _rel_close(ts.grad.numpy(), gj)
    assert ti.grad is None
    assert (ts.grad < 0).float().mean() > 0.99


@pytest.mark.parametrize('normalize', [True, False])
def test_permutohedral_attention_matches_jax(normalize):
    r = np.random.default_rng(4)
    f = r.uniform(0, 3, (2, 64, 3)).astype(np.float32)
    v = r.uniform(0, 1, (2, 64, 5)).astype(np.float32)
    got = t_pam(torch.from_numpy(f), torch.from_numpy(v), normalize)
    assert got.shape == (2, 64, 5) and got.dtype == torch.float32
    _rel_close(got.numpy(), j_pam(jnp.asarray(f), jnp.asarray(v),
                                  normalize))
    if normalize:
        # the Gaussian-kernel attention, approximated by the lattice
        d2 = ((f[0][:, None] - f[0][None]) ** 2).sum(-1)
        wgt = np.exp(-0.5 * d2)
        want = (wgt @ v[0]) / wgt.sum(1, keepdims=True)
        assert np.corrcoef(got[0].numpy().ravel(), want.ravel())[0, 1] > 0.98


def test_built_on_first_use_not_on_import(monkeypatch):
    def no_compiler(*a, **k):
        raise AssertionError('a build ran on import')
    monkeypatch.setattr(subprocess, 'run', no_compiler)
    importlib.reload(t_native)
    monkeypatch.undo()
    assert t_native.library_path().name.startswith('libpermutohedral-')
    assert t_native.build_library() == t_native.library_path()
    assert t_native.library_path().exists()


def test_concurrent_builds_each_find_a_whole_library(tmp_path, monkeypatch):
    """Six threads build into an empty directory at once: each gets the
    same library, it loads and filters, and no temporary file is left."""
    monkeypatch.setattr(t_native, 'BUILD', tmp_path)
    got, errors = [], []

    def build():
        try:
            got.append(t_native.build_library())
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(got) == 6 and len(set(got)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [got[0].name]
    import ctypes
    assert ctypes.CDLL(str(got[0])).permutohedral_filter is not None
