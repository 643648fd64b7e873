"""The port's Wiener restoration study (srcaco2_tpu_torch/diagnosis/
restore.py) against the JAX package's.

The port computes the estimator with torch.fft in f32, JAX with DFT
matmuls in f32 at HIGHEST precision: the two agree to f32 rounding.
Stated tolerance: the float output (before uint8_round) within 2e-5 of
JAX's absolutely (images in [0, 1]; the gain is at most ~1e2 at the
smallest balance), and at most 1% of the uint8 pixels (after clip and
uint8_round) off by one, none by more. The study's rows are held within
1e-4 of max(1, |JAX's|) (PSNR within 1e-4 dB): they are means over
uint8 pixels of which those few may differ."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from srcaco2_tpu import constants
from srcaco2_tpu.diagnosis import restore as JR
from srcaco2_tpu_torch.diagnosis import restore as TR

FLOAT_ATOL = 2e-5
U8_OFF_BY_ONE_SHARE = 0.01
ROW_TOL = 1e-4


def _image(seed=0, n=64):
    rng = np.random.default_rng(seed)
    img = ndi.gaussian_filter(rng.random((n, n)), 3.0)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    img[::8] = 0.9
    img[:, ::8] = 0.1
    return img.astype(np.float32)


def _u8(x):
    return np.round(np.clip(np.asarray(x, np.float32), 0, 1) * 255.0)


@pytest.mark.parametrize('balance', [1e-3, 1e-2, 1e-1, 1.0])
@pytest.mark.parametrize('shape', [(64, 64), (80, 96), (2, 1, 33, 40)])
def test_wiener_filter_equals_jax(balance, shape):
    rng = np.random.default_rng(1)
    img = np.clip(_image(3, 96)[:shape[-2], :shape[-1]]
                  + 0.02 * rng.standard_normal(shape[-2:]), 0, 1)
    img = np.broadcast_to(img, shape).astype(np.float32).copy()
    psf = TR.box_psf(5)
    got = TR.wiener_filter(torch.from_numpy(img), psf, balance).numpy()
    want = np.asarray(JR.wiener_filter(jnp.asarray(img), psf, balance))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FLOAT_ATOL
    d = np.abs(_u8(got) - _u8(want))
    assert d.max() <= 1 and (d == 1).mean() <= U8_OFF_BY_ONE_SHARE


def test_wiener_recovers_circular_box_blur():
    img = _image()
    psf = TR.box_psf(5)
    blurred = ndi.convolve(img, psf, mode='wrap')
    rec = TR.wiener_filter(torch.from_numpy(blurred), psf, 1e-8).numpy()
    assert np.abs(rec - img).max() < 1e-2
    assert np.abs(rec - img).mean() < 1e-3


def test_wiener_forward_equals_jax():
    rng = np.random.default_rng(2)
    l_im = rng.random((2, 1, 16, 16)).astype(np.float32)
    got = TR.make_wiener_forward(2, 0.01)(None, {'l_im': torch.from_numpy(
        l_im)}).numpy()
    want = np.asarray(JR.make_wiener_forward(2, 0.01)(
        None, {'l_im': jnp.asarray(l_im)}))
    assert got.shape == want.shape == (2, 1, 32, 32)
    d = np.abs(got - want)
    assert d.max() <= 1 and (d == 1).mean() <= U8_OFF_BY_ONE_SHARE


@pytest.fixture(scope='module')
def tiny_root(tmp_path_factory):
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp('wienerds'))
    make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=1, n_val=1,
                           n_test=3, size=64)
    return root


def test_wiener_study_equals_jax(tiny_root, tmp_path):
    bal = (1e-2, 1e-1)
    got = TR.wiener_study(tiny_root, tiny_root, 2, 'CELL0', balances=bal,
                          out_dir=str(tmp_path / 'study'), n_panels=1,
                          device='cpu')
    want = JR.wiener_study(tiny_root, tiny_root, 2, 'CELL0', balances=bal)
    assert set(got) == set(want) == {'bicubic', 1e-2, 1e-1}
    for k in want:
        for scope in ('full', 'roi'):
            for m, v in want[k][scope].items():
                assert abs(got[k][scope][m] - float(v)) <= \
                    ROW_TOL * max(1.0, abs(float(v))), (k, scope, m)
    assert got['bicubic']['full'] == pytest.approx(want['bicubic']['full'],
                                                   rel=1e-6)
    out = str(tmp_path / 'study')
    assert os.path.isfile(os.path.join(out, 'wiener_study.yaml'))
    assert len([f for f in os.listdir(out) if f.endswith('.png')]) == 1


def test_wiener_study_needs_a_card_or_device_cpu(tiny_root):
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TR.wiener_study(tiny_root, tiny_root, 2, 'CELL0')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TR.main(['--data_root', tiny_root, '--scale', '2'])


def test_main_on_the_cpu(tiny_root, capsys):
    res = TR.main(['--data_root', tiny_root, '--scale', '2', '--balances',
                   '0.1', '--device', 'cpu'])
    assert set(res) == {'bicubic', 0.1}
    assert '[balance=0.1] psnr' in capsys.readouterr().out
    assert np.isfinite(res[0.1]['full'][constants.PSNR_MTR])
