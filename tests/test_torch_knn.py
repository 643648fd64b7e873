"""The port's patch-exemplar studies (srcaco2_tpu_torch/diagnosis:
knn_patches, patch_dict) against the JAX package's.

The k-NN indices equal JAX's chunked_knn exactly, ties included (uint8
patches, integer ring weights: exact f32 distances), for k = 1 and
k = 3 and across the edges of query and dictionary blocks. The port
draws knn_restore's samples from a torch.Generator (JAX's jax.random
draws cannot be reproduced): a dictionary of one atom per entry gives
JAX's image bit for bit, and an ambiguous one gives atoms at its
empirical frequencies. patch_dict samples with numpy as JAX does, so its
reconstructions and studies are bit-equal to JAX's."""
import os

import numpy as np
import pytest
import torch

from srcaco2_tpu.diagnosis import knn_patches as JK
from srcaco2_tpu.diagnosis import patch_dict as JPD
from srcaco2_tpu_torch.diagnosis import knn_patches as TK
from srcaco2_tpu_torch.diagnosis import patch_dict as TPD


def _consistent_pair(rng, h=20, w=16):
    l_img = rng.integers(0, 255, (h, w), np.uint8)
    return l_img, np.kron(l_img, np.ones((2, 2), np.uint8))


def test_dictionary_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for sz, c in ((1, 300.0), (3, 300.0), (5, 10.0)):
        assert np.array_equal(TK.ring_weights(sz, c), JK.ring_weights(sz, c))
    l_img = rng.integers(0, 4, (12, 10), np.uint8)
    h_img = rng.integers(0, 3, (24, 20), np.uint8)
    got, want = TK.extract_pairs(l_img, h_img, 3), \
        JK.extract_pairs(l_img, h_img, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    dg, dw = TK.build_dict([got], 3), JK.build_dict([want], 3)
    assert dg.keys() == dw.keys()
    for k in dg:
        assert np.array_equal(dg[k], dw[k]), k


def _tied_inputs(seed, n=61, m=47):
    """Few distinct values: many exactly equal distances."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 3, (n, 9)).astype(np.float32)
    d = rng.integers(0, 3, (m, 9)).astype(np.float32)
    d[10:20] = d[0]                     # duplicate rows: exact ties
    return q, d, TK.ring_weights(3).reshape(-1)


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('blocks', [None, (7, 5), (16, 10), (61, 1)])
def test_chunked_knn_indices_equal_jax_with_ties(k, blocks):
    """(query rows, dictionary rows) per block (chunk, rows): the
    default, and blocks whose edges cut through the tied rows."""
    q, d, ring = _tied_inputs(k)
    want = np.asarray(JK.chunked_knn(q, d, ring, k=k, chunk=8))
    chunk, rows = blocks or (None, None)
    got = TK.chunked_knn(q, d, ring, k=k, chunk=chunk, rows=rows,
                         device='cpu')
    assert got.dtype == torch.int64 and got.shape == (len(q), k)
    assert np.array_equal(got.numpy(), want)
    # the ties are there: some query has equal distances at its k-th
    dist = (np.abs(q[:, None] - d[None]) * ring).sum(-1)
    kth = np.sort(dist, 1)[:, k - 1:k + 1]
    assert (kth[:, 0] == kth[:, 1]).any()


def test_knn_restore_one_atom_entries_equal_jax():
    """Every entry one atom (HR = nearest upsample of LR): the draw is
    deterministic, the image equal to JAX's and to the HR, for seen
    content and for an unseen probe (nearest neighbours)."""
    rng = np.random.default_rng(1)
    l_img, h_img = _consistent_pair(rng)
    d = TK.build_dict([TK.extract_pairs(l_img, h_img, 3)], 3)
    assert (d['n'] == 1).all()
    got = TK.knn_restore(l_img, d, k=1, seed=0, device='cpu')
    assert np.array_equal(got, JK.knn_restore(l_img, d, k=1, seed=0))
    assert np.array_equal(got, h_img)
    probe = np.clip(l_img.astype(np.int32)
                    + rng.integers(-2, 3, l_img.shape), 0, 255
                    ).astype(np.uint8)
    got = TK.knn_restore(probe, d, k=1, seed=5, device='cpu')
    assert np.array_equal(got, JK.knn_restore(probe, d, k=1, seed=5))


def test_knn_restore_draw_frequencies():
    """One LR entry with atoms at empirical probabilities 0.7 / 0.2 /
    0.1: over 4096 pixels each atom is drawn at its probability (within
    5 binomial sigmas), and the seed makes the draw repeatable; k = 3
    picks its neighbour uniformly."""
    l_img = np.zeros((64, 64), np.uint8)
    d = TK.build_dict([TK.extract_pairs(l_img, np.zeros((128, 128),
                                                        np.uint8), 3)], 3)
    d['atoms_h'] = np.array([[[10] * 4, [20] * 4, [30] * 4]], np.float32)
    d['probs'] = np.array([[0.7, 0.2, 0.1]], np.float32)
    rec = TK.knn_restore(l_img, d, seed=3, device='cpu')
    assert np.array_equal(rec, TK.knn_restore(l_img, d, seed=3,
                                              device='cpu'))
    atoms = rec.reshape(64, 2, 64, 2)[:, 0, :, 0].ravel()
    n = atoms.size
    for v, p in ((10, 0.7), (20, 0.2), (30, 0.1)):
        assert abs((atoms == v).mean() - p) <= 5 * np.sqrt(p * (1 - p) / n)
    pick, _ = TK.knn_draws(30000, 3, 0)
    freq = np.bincount(pick.numpy(), minlength=3) / 30000
    assert np.abs(freq - 1 / 3).max() < 0.02
    # k = 3 over three one-atom entries at equal distance: each is used
    img = np.zeros((32, 32), np.uint8)
    d3 = {'atoms_l': np.array([[1] * 9, [2] * 9, [3] * 9], np.float32),
          'atoms_h': np.array([[[1] * 4], [[2] * 4], [[3] * 4]],
                              np.float32),
          'probs': np.ones((3, 1), np.float32),
          'n': np.ones(3, np.int32), 'sz': 3}
    d3['atoms_l'][:, 4] = 0      # centres equal: distances 8, 16, 24
    rec = TK.knn_restore(img, d3, k=3, seed=0, device='cpu')
    share = np.bincount(rec.ravel(), minlength=4)[1:] / rec.size
    assert np.abs(share - 1 / 3).max() < 0.05


def test_knn_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    q, d, ring = _tied_inputs(0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TK.chunked_knn(q, d, ring)


@pytest.mark.parametrize('sample', [False, True])
@pytest.mark.parametrize('fallback', ['knn', 'bicubic'])
def test_exact_match_restore_equals_jax(sample, fallback):
    """An ambiguous dictionary (noisy HR) and an unseen probe: the
    exact hits, the knn (or bicubic) misses and the numpy draws equal
    JAX's bit for bit."""
    rng = np.random.default_rng(2)
    l_img = rng.integers(0, 8, (24, 24), np.uint8)
    h_img = np.clip(np.kron(l_img, np.ones((2, 2), np.uint8)).astype(int)
                    + rng.integers(0, 3, (48, 48)), 0, 255).astype(np.uint8)
    d = TK.build_dict([TK.extract_pairs(l_img, h_img, 3)], 3)
    probe = np.clip(l_img.astype(np.int32)
                    + rng.integers(-1, 2, l_img.shape), 0, 255
                    ).astype(np.uint8)
    got, cov = TPD.exact_match_restore(probe, d, fallback=fallback,
                                       seed=4, sample=sample, chunk=100,
                                       device='cpu')
    want, cov_j = JPD.exact_match_restore(probe, d, fallback=fallback,
                                          seed=4, sample=sample, chunk=100)
    assert 0.0 < cov == cov_j < 1.0
    assert np.array_equal(got, want)


def test_self_reconstruction_and_stats_equal_jax():
    rng = np.random.default_rng(3)
    l_img = (rng.random((16, 16)) < 0.1).astype(np.uint8)   # repeats
    h_img = np.clip(np.kron(l_img, np.ones((2, 2), np.uint8)).astype(int)
                    + rng.integers(0, 2, (32, 32)), 0, 255).astype(np.uint8)
    got = TPD.self_reconstruction(l_img, h_img, sz=3, seed=1)
    want = JPD.self_reconstruction(l_img, h_img, sz=3, seed=1)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
        else:
            assert got[k] == want[k], k
    assert got['frac_ambiguous'] > 0


@pytest.fixture(scope='module')
def tiny_ds(tmp_path_factory):
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp('knnds'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=2,
                                   n_val=1, n_test=1, size=32)
    return root, names


def test_run_studies_end_to_end(tiny_ds, tmp_path):
    """run_knn_demo and run_patch_dict_study on the CPU: the knn demo's
    dictionary and bicubic row equal JAX's; the patch-dict study (numpy
    draws) equals JAX's summary."""
    root, names = tiny_ds
    got = TK.run_knn_demo(root, root, names[0], names[2],
                          str(tmp_path / 'k'), n_test=1, device='cpu')
    want = JK.run_knn_demo(root, root, names[0], names[2],
                           str(tmp_path / 'kj'), n_test=1)
    for k in ('dict_size', 'avg_atoms_per_entry', 'sz_l', 'kn'):
        assert got[k] == want[k]
    assert got['psnr_bicubic'] == pytest.approx(want['psnr_bicubic'],
                                                abs=1e-4)
    assert os.path.isfile(str(tmp_path / 'k' / 'log.txt'))
    got = TPD.run_patch_dict_study(root, root, names[0], names[2],
                                   str(tmp_path / 'p'), n_test=1,
                                   device='cpu')
    want = JPD.run_patch_dict_study(root, root, names[0], names[2],
                                    str(tmp_path / 'pj'), n_test=1)
    assert got['stats'] == want['stats'] and got['sz_l'] == want['sz_l']
    for rg, rw in zip(got['test'], want['test']):
        assert rg['coverage'] == rw['coverage']
        assert rg['psnr_dict'] == pytest.approx(rw['psnr_dict'], abs=2e-3)
    assert os.path.isfile(str(tmp_path / 'p' / 'summary.yaml'))
    assert os.path.isfile(str(tmp_path / 'p' / 'patch_dict_0.png'))
