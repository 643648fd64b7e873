"""The port's data layer against the JAX package's: the synthetic
dataset (the same pixels for one seed, read back with cv2), the numpy
TIFF / PNG codec the port uses without cv2 (round trips, cv2 reads what
it writes, it refuses what it cannot read), the fold files, load_dataset
(hr, lr, ids and paths bit for bit) and the noiseless LR synthesis."""
import os

import cv2
import numpy as np
import pytest

from srcaco2_tpu import constants as JC
from srcaco2_tpu.data import dataset as JD
from srcaco2_tpu.data import folds as JF
from srcaco2_tpu.data.synthetic import make_synthetic_dataset as j_make
from srcaco2_tpu_torch.data import dataset as TD
from srcaco2_tpu_torch.data import folds as TF
from srcaco2_tpu_torch.data import io as TIO
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset as t_make


def _tree_images(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, 'caco2')):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = cv2.imread(
                os.path.join(d, f), cv2.IMREAD_UNCHANGED)
    return out


def _fold_text(root):
    out = {}
    fd = os.path.join(root, 'folds', 'super-resolution')
    for ds in os.listdir(fd):
        for f in ('l_h.txt', 'h_l.txt'):
            with open(os.path.join(fd, ds, f)) as fh:
                out[(ds, f)] = fh.read()
    return out


@pytest.mark.parametrize('style', ['blobs', 'rich'])
def test_synthetic_dataset_matches_jax(tmp_path, style):
    kw = dict(scale=4, cell='CELL1', n_train=2, n_val=1, n_test=1,
              size=64, seed=3, style=style)
    jn = j_make(str(tmp_path / 'j'), **kw)
    tn = t_make(str(tmp_path / 't'), **kw)
    assert jn == tn
    ji, ti = _tree_images(str(tmp_path / 'j')), _tree_images(
        str(tmp_path / 't'))
    assert sorted(ji) == sorted(ti) and len(ji) == 8
    for k in ji:
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    assert _fold_text(str(tmp_path / 'j')) == _fold_text(str(tmp_path / 't'))


@pytest.mark.parametrize('shape', [(37, 53), (20, 31, 3)])
def test_numpy_codec_round_trips_and_cv2_reads_it(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    tif, png = str(tmp_path / 'a.tif'), str(tmp_path / 'a.png')
    TIO.write_tiff(tif, img)
    TIO.write_png(png, img)
    np.testing.assert_array_equal(TIO.read_tiff(tif), img)
    for path in (tif, png):
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            got = cv2.cvtColor(got, cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, img, err_msg=path)


@pytest.mark.parametrize('shape', [(24, 40), (24, 40, 3)])
@pytest.mark.parametrize('n_channels', [1, 3])
def test_imread_without_cv2_matches_cv2(tmp_path, monkeypatch, shape,
                                        n_channels):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / 'a.tif')
    TIO.write_tiff(path, img)
    ref = TIO.imread_uint(path, n_channels)
    monkeypatch.setattr(TIO, 'cv2', None)
    got = TIO.imread_uint(path, n_channels)
    assert got.shape == ref.shape == (24, 40, n_channels)
    np.testing.assert_array_equal(got, ref)


def test_numpy_codec_reads_16bit_and_refuses_compressed(tmp_path,
                                                        monkeypatch):
    img16 = np.random.default_rng(2).integers(0, 4096, (16, 24),
                                              dtype=np.uint16)
    path = str(tmp_path / 'u16.tif')
    cv2.imwrite(path, img16, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    ref = TIO.imread_uint(path, 1)
    lzw = str(tmp_path / 'lzw.tif')
    cv2.imwrite(lzw, img16.astype(np.uint8))
    monkeypatch.setattr(TIO, 'cv2', None)
    np.testing.assert_array_equal(TIO.read_tiff(path), img16)
    np.testing.assert_array_equal(TIO.imread_uint(path, 1), ref)
    with pytest.raises(ValueError, match='cv2'):
        TIO.imread_uint(lzw, 1)
    with pytest.raises(ValueError, match='cv2'):
        TIO.imsave(img16.astype(np.uint8), str(tmp_path / 'a.jpg'))


def test_folds_match_jax(tmp_path):
    """The repository's folds.zip, extracted by both packages."""
    for ds in (JC.caco2_name('train', 2, 'CELL0'),
               JC.caco2_name('test', 8, 'CELL2')):
        jl = JF.get_pairs(str(tmp_path / 'j'), ds)
        tl = TF.get_pairs(str(tmp_path / 't'), ds)
        assert jl == tl and len(jl[0]) > 0
        for frac in (0.3, 1.0):
            assert TF.subset_fraction(tl[0], frac) == \
                JF.subset_fraction(jl[0], frac)


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    names = t_make(root, scale=2, cell='CELL0', n_train=3, n_val=2,
                   n_test=2, size=64)
    return root, names


def _ds_args(root, **kw):
    return {'data_root': root, 'splits_root': root, 'scale': 2,
            'n_channels': 1, 'myseed': 0, 'use_interpolated_low': False,
            'inter_low_th': 7.0, 'inter_low_sigma': 6.0, 'num_workers': 2,
            'task': 'super-resolution', **kw}


@pytest.mark.parametrize('phase,n,frac', [('train', -1, 1.0),
                                          ('train', -1, 0.5),
                                          ('eval', 1, 1.0)])
def test_load_dataset_matches_jax(synth_root, phase, n, frac):
    root, names = synth_root
    name = names[0] if phase == 'train' else names[1]
    j = JD.load_dataset(_ds_args(root), name, phase, n=n, frac=frac)
    t = TD.load_dataset(_ds_args(root), name, phase, n=n, frac=frac)
    for f in ('hr', 'lr'):
        assert getattr(t, f).dtype == np.uint8
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ('name', 'phase', 'scale', 'n_channels', 'ids', 'h_paths',
              'l_paths', 'lr_is_real'):
        assert getattr(t, f) == getattr(j, f), f
    t.stage('cpu')
    np.testing.assert_array_equal(t.hr_dev.numpy(), t.hr)


def test_synth_lr_without_noise_matches_jax(synth_root):
    root, names = synth_root
    hr = TD.load_dataset(_ds_args(root), names[0], 'train').hr
    j = JD.synth_lr_from_hr(hr, 2, 0, 7.0, 6.0, simulate_noise=False,
                            batch=2)
    t = TD.synth_lr_from_hr(hr, 2, 0, 7.0, 6.0, simulate_noise=False,
                            batch=2)
    np.testing.assert_array_equal(t, j)
    noisy = TD.synth_lr_from_hr(hr, 2, 0, 7.0, 6.0, simulate_noise=True)
    assert noisy.shape == t.shape and noisy.dtype == np.uint8
    np.testing.assert_array_equal(
        noisy, TD.synth_lr_from_hr(hr, 2, 0, 7.0, 6.0, simulate_noise=True))
    assert (noisy != t).any()


def test_reconstruct_task_raises(synth_root):
    """The reconstruct task maps a train split as JAX does (the blurred
    LR -> the LR at scale 1) and raises only where JAX raises:
    reconstruct_input=real in a train phase."""
    root, names = synth_root
    args = _ds_args(root, task='reconstruct')
    j = JD.load_dataset(args, names[0], 'train')
    t = TD.load_dataset(args, names[0], 'train')
    assert t.scale == j.scale == 1 and t.l_paths == j.l_paths
    np.testing.assert_array_equal(t.hr, j.hr)
    np.testing.assert_array_equal(t.lr, j.lr)
    with pytest.raises(ValueError, match='eval-only'):
        TD.load_dataset({**args, 'reconstruct_input': 'real'}, names[0],
                        'train')
