"""The port's host utilities against the JAX package's: diagnosis/tools,
diagnosis/tvl1_flow, the three figures of diagnosis/visualize,
data/build_scripts, data/augmenter (and io.cv2_resize_cubic_uint8),
utils/image_utils and utils/profiling. The numpy code is a copy and
must give the same arrays; where a resize runs in torch, within 1e-4 of
JAX's on [0, 255] values."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcaco2_tpu.data import augmenter as JA
from srcaco2_tpu.data import build_scripts as JB
from srcaco2_tpu.data import io as JIO
from srcaco2_tpu.diagnosis import tools as JT
from srcaco2_tpu.diagnosis import tvl1_flow as JF
from srcaco2_tpu.utils import image_utils as JU
from srcaco2_tpu_torch.data import augmenter as TA
from srcaco2_tpu_torch.data import build_scripts as TB
from srcaco2_tpu_torch.data import io as TIO
from srcaco2_tpu_torch.data.synthetic import _cell_image
from srcaco2_tpu_torch.diagnosis import tools as TT
from srcaco2_tpu_torch.diagnosis import tvl1_flow as TF
from srcaco2_tpu_torch.diagnosis import visualize as TV
from srcaco2_tpu_torch.utils import image_utils as TU
from srcaco2_tpu_torch.utils import profiling as TP


# ---------------------------------------------------------- image_utils
def test_image_utils_equal_jax():
    img = np.random.default_rng(0).integers(0, 256, (16, 12, 1)
                                            ).astype(np.uint8)
    s = TU.uint2single(img)
    assert np.array_equal(s, JU.uint2single(img))
    assert np.array_equal(TU.single2uint(s), img)
    t = TU.single2tensor3(s)
    assert np.array_equal(t, JU.single2tensor3(s))
    assert np.array_equal(TU.tensor2uint(t), JU.tensor2uint(t))
    assert np.array_equal(TU.tensor2single(t), JU.tensor2single(t))
    for m in range(8):
        assert np.array_equal(TU.augment_img(s, m), JU.augment_img(s, m))
    assert TU.modcrop(img, 5).shape == (15, 10, 1)
    assert TU.shave(img, 2).shape == (12, 8, 1)
    for a in (img[..., 0].astype(np.float32), img.astype(np.float32)):
        np.testing.assert_allclose(TU.imresize_np(a, 0.5),
                                   JU.imresize_np(a, 0.5), atol=1e-4)
    x = np.linspace(-0.2, 1.2, 50).astype(np.float32)
    assert np.array_equal(TU.tensor2uint82float(x).numpy(),
                          np.asarray(JU.tensor2uint82float(x)))
    assert TU.is_caco2('/d/caco2/x.tif') and not TU.is_biosr('x')
    from srcaco2_tpu_torch.ops import metrics as M
    assert TU.mbatch_gpu_calculate_psnr is M.mb_psnr


# ------------------------------------------------------------ profiling
def test_profiling_hooks(tmp_path):
    with TP.trace_window(str(tmp_path / 'off'), enabled=False) as p:
        assert p is None
    assert not (tmp_path / 'off').exists()
    with TP.trace_window(str(tmp_path / 'tr')) as prof:
        with TP.span('my_span'):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.load(open(prof.trace_file))['traceEvents']
    assert os.path.dirname(prof.trace_file) == str(tmp_path / 'tr')
    assert any(e.get('name') == 'my_span' for e in events)
    assert any('mm' in str(e.get('name')) for e in events)


# ------------------------------------------------------------ augmenter
def test_cv2_resize_cubic_uint8_equals_jax(monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (9, 7, 1)
                                            ).astype(np.uint8)
    for wh in ((14, 18), (3, 4)):
        assert np.array_equal(TIO.cv2_resize_cubic_uint8(img, wh),
                              JIO.cv2_resize_cubic_uint8(img, wh))
    # without cv2: the torch bicubic, rounded, as JAX's fallback
    monkeypatch.setattr(TIO, 'cv2', None)
    monkeypatch.setattr(JIO, '_HAS_CV2', False)
    got = TIO.cv2_resize_cubic_uint8(img, (14, 18))
    want = JIO.cv2_resize_cubic_uint8(img, (14, 18))
    assert got.shape == (18, 14, 1) and np.abs(
        got.astype(int) - want.astype(int)).max() <= 1
    assert TIO.cv2_resize_cubic_uint8(img[..., 0], (14, 18)).shape == \
        (18, 14, 1)


@pytest.mark.parametrize('steps,roi', [(2, False), (3, True)])
def test_augmenter_equals_jax(steps, roi):
    rng = np.random.default_rng(0)
    hr = _cell_image(rng, 64).astype(np.float64)
    lr = hr[::4, ::4]
    mask = (hr >= 4).astype(np.float64)
    got = TA.Augment(4, steps, roi, seed=1).perturbate(lr, hr, mask)
    want = JA.Augment(4, steps, roi, seed=1).perturbate(lr, hr, mask)
    assert np.array_equal(got, want)
    assert got.shape == hr.shape and 0 <= got.min() and got.max() <= 255


# ----------------------------------------------------------------- tools
@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp('diag'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL1', n_train=4,
                                   n_val=2, n_test=2, size=64)
    return root, names


def test_tools_equal_jax(synth, tmp_path):
    import glob
    from srcaco2_tpu_torch.data.dataset import load_dataset
    root, names = synth
    assert TT.check_data(root, root, names[0], sample=2) == \
        JT.check_data(root, root, names[0], sample=2)
    victim = sorted(glob.glob(os.path.join(root, 'caco2', 'hr_div_2',
                                           '*.tif')))[0]
    os.rename(victim, victim + '.bak')
    try:
        rep = TT.check_data(root, root, names[0])
        assert rep == JT.check_data(root, root, names[0])
        assert not rep['ok'] and rep['missing_low'] >= 1
    finally:
        os.rename(victim + '.bak', victim)
    args = {'data_root': root, 'splits_root': root, 'scale': 2,
            'n_channels': 1, 'myseed': 0, 'use_interpolated_low': False,
            'inter_low_th': 7., 'inter_low_sigma': 6., 'num_workers': 2}
    ds = load_dataset(args, names[0], 'train')
    assert TT.patch_stats(ds.hr) == JT.patch_stats(ds.hr)
    got, want = TT.noise_model_study(ds.hr, ds.lr, 2), \
        JT.noise_model_study(ds.hr, ds.lr, 2)
    assert got['intensity'] == want['intensity']
    assert got['count'] == want['count']
    np.testing.assert_allclose(got['noise_std'], want['noise_std'],
                               atol=1e-4)
    assert got['global_std'] == pytest.approx(want['global_std'], abs=1e-4)
    assert TT.color_distribution({'train': ds.hr}) == \
        JT.color_distribution({'train': ds.hr})
    out = TT.plot_patch_demo(_cell_image(np.random.default_rng(0), 128),
                             str(tmp_path / 'demo.png'), psize=32, n_draws=8)
    assert os.path.isfile(out)


# ------------------------------------------------------------------ tvl1
def test_tvl1_equals_jax():
    from srcaco2_tpu_torch.data.synthetic import rich_cell_tile
    tile = rich_cell_tile(np.random.default_rng(0), 64, 'CELL0'
                          ).astype(np.float64)
    img = TF._warp(tile, np.full_like(tile, 1.5), np.full_like(tile, -0.8))
    assert np.array_equal(img, JF._warp(tile, np.full_like(tile, 1.5),
                                        np.full_like(tile, -0.8)))
    got, want = TF.optical_flow_tvl1(tile, img), \
        JF.optical_flow_tvl1(tile, img)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    c = (slice(8, -8),) * 2
    roi = tile[c] >= 10.0
    err = np.sqrt((got[0][c] + 1.5) ** 2 + (got[1][c] - 0.8) ** 2)
    assert float(err[roi].mean()) < 0.5


# ------------------------------------------------------------- visualize
@pytest.fixture()
def cell_img():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:128, :128]
    img = np.zeros((128, 128), np.float32)
    for _ in range(14):
        cy, cx = rng.integers(10, 118, 2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 64] = rng.integers(80, 220)
    return img.astype(np.uint8)


def test_figures(cell_img, tmp_path):
    rng = np.random.default_rng(1)
    lr = np.clip(cell_img[::2, ::2].astype(np.int16)
                 + rng.normal(0, 5, (64, 64)).astype(np.int16), 0, 255
                 ).astype(np.uint8)
    outs = [TV.patch_sampling_demo(cell_img, 32, str(tmp_path / 'd.png')),
            TV.noise_model_plot(cell_img, lr, 2, str(tmp_path / 'n.png'),
                                study={0.0: {'psnr': 30.0, 'ssim': 0.9},
                                       10.0: {'psnr': 25.0, 'ssim': 0.8}}),
            TV.color_distribution({'CELL0': [cell_img],
                                   'CELL2': [cell_img[::-1]]},
                                  str(tmp_path / 'c.png'))]
    assert all(os.path.getsize(o) > 10_000 for o in outs)


def test_noise_residual_equals_jax(cell_img):
    """noise_model_plot's numbers: the clean downscale and the binned
    residual statistics, as JAX's figure computes them."""
    from srcaco2_tpu.ops.resize import resize2d
    rng = np.random.default_rng(2)
    lr = np.clip(cell_img[::2, ::2] + rng.normal(0, 5, (64, 64)), 0,
                 255).astype(np.uint8)
    got = TV.noise_residual(cell_img, lr)
    clean = np.asarray(resize2d(jnp.asarray(cell_img.astype(np.float32))
                                [None, None] / 255.0, (64, 64)))[0, 0] * 255.0
    np.testing.assert_allclose(got['clean'], clean, atol=1e-4)
    resid = lr.astype(np.float32) - clean
    np.testing.assert_allclose(got['resid'], resid, atol=1e-4)
    bins = np.linspace(0, 255, 18)
    ctr = [0.5 * (a + b) for a, b in zip(bins[:-1], bins[1:])
           if ((clean >= a) & (clean < b)).sum() > 20]
    assert got['centers'] == ctr


def test_figures_without_matplotlib(cell_img, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    with pytest.raises(ImportError, match='matplotlib'):
        TV.color_distribution({'C': [cell_img]}, str(tmp_path / 'c.png'))
    with pytest.raises(ImportError, match='matplotlib'):
        TT.plot_patch_demo(cell_img, str(tmp_path / 'd.png'), psize=32)


# ---------------------------------------------------------- build_scripts
HR, PSIZE, BORDER = 128, 32, 8


def _sessions(pkg, root, seed=0):
    rng = np.random.default_rng(seed)
    sessions = []
    for si, (off, order) in enumerate([(0, (0, 1, 2)), (10, (2, 1, 0))]):
        dirs = {sc: os.path.join(root, f'session{si}', f'res{sc}')
                for sc in (1, 2, 4, 8)}
        for t in (1, 2):
            yy, xx = np.mgrid[:HR, :HR]
            hr = np.zeros((3, HR, HR), np.uint8)
            for c in range(3):
                for _ in range(12):
                    cy, cx = rng.integers(8, HR - 8, 2)
                    r = rng.integers(4, 10)
                    hr[c][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = \
                        rng.integers(60, 200)
            raw = hr[np.argsort(np.asarray(order))]
            for sc, d in dirs.items():
                img = raw if sc == 1 else np.roll(raw, int(rng.integers(
                    -2, 3)), 1)[:, ::sc, ::sc]
                pkg._imsave_chw(img, os.path.join(d, f'exp_Tile{t}_acq.tif'))
        sessions.append(pkg.SessionSpec(res_dirs=dirs, tile_offset=off,
                                        channel_order=order))
    return sessions


def test_build_caco2_from_raw_equals_jax(tmp_path):
    """The same raw sessions (written by the port) through both builders:
    the same fold counts, fold files and patches."""
    counts = {}
    for tag, pkg in (('port', TB), ('jax', JB)):
        root = str(tmp_path / tag)
        counts[tag] = pkg.build_caco2_from_raw(
            _sessions(TB, root), root, hr_size=HR, psize=PSIZE,
            del_border=BORDER, min_area=0.05, threshold=4.0,
            n_test_tiles=1, n_valid_tiles=1)
    assert counts['port'] == counts['jax'] and counts['port']['_sampled'] > 0
    a, b = str(tmp_path / 'port'), str(tmp_path / 'jax')
    folds = os.path.join('folds', 'super-resolution')
    for ds in sorted(os.listdir(os.path.join(a, folds))):
        for f in ('l_h.txt', 'h_l.txt'):
            assert open(os.path.join(a, folds, ds, f)).read() == \
                open(os.path.join(b, folds, ds, f)).read()
    hr_dir = os.path.join('caco2', 'hr_div_1')
    for f in sorted(os.listdir(os.path.join(a, hr_dir)))[:6]:
        assert np.array_equal(TIO.imread_uint(os.path.join(a, hr_dir, f)),
                              TIO.imread_uint(os.path.join(b, hr_dir, f)))
    info = TB.get_info_patch(f)
    assert info == JB.get_info_patch(f) and info['ii'] - info['i'] == PSIZE


def test_registration_helpers_equal_jax():
    rng = np.random.default_rng(1)
    img = _cell_image(rng, 64).astype(np.float32)
    shifted = np.roll(np.roll(img, 3, axis=0), -5, axis=1)
    assert TB.phase_correlation_shift(img, shifted) == \
        JB.phase_correlation_shift(img, shifted)
    ramp = np.tile(np.arange(64, dtype=np.float32), (64, 1))
    hr = np.stack([ramp, ramp.T, (ramp + ramp.T) / 2]).astype(np.uint8)
    low = hr.astype(np.float32).reshape(3, 16, 4, 16, 4).mean(
        (2, 4)).round().astype(np.uint8)
    for method in ('block', 'pyramid'):
        got = TB.register_im(hr, low, scale=4, del_border=8,
                             global_shift=True, method=method)
        want = JB.register_im(hr, low, scale=4, del_border=8,
                              global_shift=True, method=method)
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert np.array_equal(TB._nearest_resize(img, 20, 30),
                          JB._nearest_resize(img, 20, 30))


@pytest.mark.parametrize('codec', ['cv2', 'numpy'])
def test_tile_io_keeps_16_bits_as_jax(tmp_path, monkeypatch, codec):
    """A 16-bit and an 8-bit three-channel tile, written by the port (cv2
    or, without it, the numpy TIFF codec) and read back by the port's
    and JAX's _imread_chw: the same values, channel order and dtype."""
    rng = np.random.default_rng(3)
    tiles = {'u16': rng.integers(0, 65536, (3, 24, 20)).astype(np.uint16),
             'u8': rng.integers(0, 256, (3, 24, 20)).astype(np.uint8)}
    for name, img in tiles.items():
        path = str(tmp_path / codec / f'{name}.tif')
        if codec == 'numpy':
            monkeypatch.setattr(TIO, 'cv2', None)
        TB._imsave_chw(img, path)
        got = TB._imread_chw(path)
        monkeypatch.undo()
        assert got.dtype == img.dtype and np.array_equal(got, img)
        want = JB._imread_chw(path)
        assert want.dtype == got.dtype and np.array_equal(got, want)
