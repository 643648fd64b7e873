"""Patch-origin sampling and ppiw of the port (data/sampling.py,
data/pipeline.py) against the JAX package's: the host functions (Otsu,
ROI, the EDT, the probability maps, the host draw), the device Otsu and
the chamfer EDT exactly equal on synthetic cell tiles, the ROI / EDT /
EDT*ROI origin weights' logs within 1e-6 (relative) of the logits JAX's
_sample_origin hands to jax.random.categorical (automatic and fixed thresholds), a
chi-square test of the port's draw against its weights, and the ppiw
table and the batch's per-pixel weights exactly equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from srcaco2_tpu import constants as JC
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.data import sampling as JS
from srcaco2_tpu.ops.resize import resize2d as j_resize2d
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.data import sampling as TS
from srcaco2_tpu_torch.data.synthetic import _cell_image

SAMPLES = [JC.SAMPLE_ROI, JC.SAMPLE_EDT, JC.SAMPLE_EDTXROI]


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One torch thread: with JAX's CPU runtime in the same process,
    torch's intra-op worker threads have been seen to compute exp(5) 6e-5
    off in some runs (every element one worker handled), which is no
    arithmetic of the port's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([_cell_image(rng, size) for _ in range(n)])


@pytest.mark.parametrize('style,th', [(JC.TH_AUTO, None),
                                      (JC.TH_FIX, 60.0)])
def test_host_functions_match_jax(style, th):
    imgs = _tiles(3, 96)
    for img in imgs:
        assert TS.otsu_threshold(img) == JS.otsu_threshold(img)
        roi = TS.roi_mask(img, style, th)
        np.testing.assert_array_equal(roi, JS.roi_mask(img, style, th))
        np.testing.assert_array_equal(TS.edt_map(roi), JS.edt_map(roi))
        for st in [JC.SAMPLE_UNIF] + SAMPLES:
            np.testing.assert_allclose(
                TS.origin_prob_map(img, st, 32, style, th),
                JS.origin_prob_map(img, st, 32, style, th), rtol=1e-12)
            for seed in range(3):
                assert TS.sample_origin_host(
                    np.random.default_rng(seed), img, st, 32, style, th) \
                    == JS.sample_origin_host(np.random.default_rng(seed),
                                             img, st, 32, style, th)
    flat = np.full((8, 8), 7, np.uint8)
    assert TS.otsu_threshold(flat) == JS.otsu_threshold(flat) == 7.0


def test_device_otsu_and_edt_equal_jax():
    """A stack of tiles at once against JAX's per-image functions: the
    threshold and the chamfer EDT (48 erosions, a zero-padded map) bit
    for bit; a flat and a two-level image included."""
    imgs = np.concatenate([_tiles(4, 128), _tiles(1, 256, seed=3)[:, :128,
                                                                  :128]])
    imgs[1] = 9
    imgs[2] = np.where(imgs[2] > 100, 200, 20)
    th_t = TS.otsu_threshold_device(torch.from_numpy(imgs))
    j_otsu = jax.jit(JS.otsu_threshold_device)
    j_edt = jax.jit(JS.edt_device)
    for i, img in enumerate(imgs):
        assert float(th_t[i]) == float(j_otsu(jnp.asarray(img))), i
    roi = (imgs.astype(np.float32) >= th_t.numpy()[:, None, None]).astype(
        np.float32)
    edt_t = TS.edt_device(torch.from_numpy(roi)).numpy()
    assert edt_t.max() > 10
    for i in range(len(imgs)):
        np.testing.assert_array_equal(edt_t[i],
                                      np.asarray(j_edt(jnp.asarray(roi[i]))))


def _jax_logits(monkeypatch, l2h_u8, cfg):
    """The logits JAX's _sample_origin draws its categorical from."""
    seen = []

    def categorical(key, logits, *a, **k):
        seen.append(np.asarray(logits))
        return jnp.int32(0)
    monkeypatch.setattr(jax.random, 'categorical', categorical)
    JP._sample_origin(jax.random.key(0), jnp.asarray(l2h_u8), cfg)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize('st', SAMPLES)
@pytest.mark.parametrize('style,th', [(JC.TH_AUTO, 0.0),
                                      (JC.TH_FIX, 70.0)])
def test_origin_weights_match_jax(monkeypatch, st, style, th):
    imgs = _tiles(2, 96, seed=5).astype(np.float32)
    kw = dict(scale=4, h_size=32, sample_tr_patch=st, th_style=style,
              th_fix=th)
    w_t = TS.origin_weights(torch.from_numpy(imgs.astype(np.uint8)), st, 32,
                            style, th).numpy()
    assert w_t.shape == (2, 96 - 32, 96 - 32)
    for i in range(2):
        # in the log domain: JAX's f32 log rounds small EDT*ROI weights
        # (~1e-8, logit ~ -18.6) to 2e-6 of relative weight
        np.testing.assert_allclose(
            np.log(w_t[i].ravel()),
            _jax_logits(monkeypatch, imgs[i], JP.PipeConfig(**kw)),
            rtol=1e-6, atol=1e-6)


def test_l2h_u8_matches_jax():
    """The pre-upscale the draw weighs: JAX's round(clip(resize2d(lr)))
    per sample, within one level and exact at 99.9% (the bicubic's sums
    run in another order)."""
    lr = _tiles(3, 128, seed=2)[:, ::4, ::4, None].copy()
    got = TP.l2h_u8(torch.from_numpy(lr), (128, 128)).numpy()
    for i in range(3):
        ref = np.asarray(jnp.round(jnp.clip(j_resize2d(
            jnp.asarray(lr[i], jnp.float32).transpose(2, 0, 1),
            (128, 128)), 0, 255))[0])
        d = np.abs(got[i].astype(np.float32) - ref)
        assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_port_draw_follows_the_weights():
    """50,000 draws from the port's generator over one image's EDT*ROI
    weights, binned 8 x 8: a chi-square test against the weights' mass
    per bin at p >= 0.001 (fixed seed), and every origin inside the
    valid-center window."""
    img = torch.from_numpy(_tiles(1, 96, seed=7))
    w = TS.origin_weights(img, JC.SAMPLE_EDTXROI, 32)
    n = 50_000
    gen = torch.Generator().manual_seed(11)
    x0, y0 = TS.sample_origin_device(gen, w, k=n)
    side = w.shape[-1]
    assert x0.shape == (1, n)
    assert 0 <= int(x0.min()) and int(x0.max()) < side
    assert 0 <= int(y0.min()) and int(y0.max()) < side
    binw = side // 8
    seen = np.bincount((x0 // binw * 8 + y0 // binw).reshape(-1).numpy(),
                       minlength=64)
    p = w[0].reshape(8, binw, 8, binw).sum((1, 3)).double()
    expected = (p / p.sum()).reshape(-1).numpy() * n
    assert stats.chisquare(seen, expected).pvalue >= 1e-3
    # and the weights steer it: the busiest bin far above a uniform draw
    assert seen.max() > 2 * n / 64


def test_draw_uses_the_weights_of_each_sample():
    cfg = TP.PipeConfig(scale=4, h_size=32,
                        sample_tr_patch=JC.SAMPLE_ROI)
    lr = torch.from_numpy(_tiles(4, 128, seed=1)[:, ::4, ::4, None].copy())
    ow = TP.OriginWeights(lr, (128, 128), cfg, cache=True)
    assert ow.maps.shape == (4, 96, 96)
    idxs = torch.tensor([2, 0, 2])
    live = TP.OriginWeights(lr, (128, 128), cfg, cache=False).of(idxs)
    assert torch.equal(ow.of(idxs), live)
    d = TP.draw(torch.Generator().manual_seed(0), 3, cfg, (128, 128),
                ow.of(idxs))
    assert d.x0.shape == (3,) and int(d.x0.max()) < 96
    with pytest.raises(ValueError, match='weights'):
        TP.draw(torch.Generator(), 3, cfg, (128, 128))


def test_ppiw_table_and_batch_weights_match_jax():
    rng = np.random.default_rng(4)
    hr = _tiles(4, 64, seed=4)[..., None]
    hr[0, :4, :4] = 255
    for min_w in (0.001, 0.3):
        np.testing.assert_array_equal(TP.per_color_weights(hr, min_w),
                                      JP.per_color_weights(hr, min_w))
    flat = np.full((2, 8, 8, 1), 5, np.uint8)
    np.testing.assert_array_equal(TP.per_color_weights(flat, 0.1),
                                  JP.per_color_weights(flat, 0.1))
    lr = rng.integers(0, 256, (4, 16, 16, 1), dtype=np.uint8)
    table = JP.per_color_weights(hr, 0.001)
    idxs = np.array([1, 3, 0], np.int32)
    key = jax.random.key(3)
    cfg_j = JP.PipeConfig(scale=4, h_size=32, ppiw=True)
    bj = JP.make_train_batch(jnp.asarray(hr), jnp.asarray(lr),
                             jnp.asarray(idxs), key, cfg_j,
                             jnp.asarray(table))
    from test_torch_train_parts import jax_draws
    draws = jax_draws(key, 3, 64, 32)
    bt = TP.assemble(torch.from_numpy(hr), torch.from_numpy(lr),
                     torch.from_numpy(idxs), draws,
                     TP.PipeConfig(scale=4, h_size=32, ppiw=True),
                     torch.from_numpy(table))
    np.testing.assert_array_equal(bt['h_per_pixel_weight'].numpy(),
                                  np.asarray(bj['h_per_pixel_weight']))
