"""The LR-only local augs of the port's pipeline against the JAX
package's (data/pipeline.py: _block_mask, _gauss_blur,
_apply_local_augs), with JAX's draws re-derived from its keys: the
block mask exactly, the blur within 1e-6 (a radius past the patch side
included: the reflection repeats, as jnp.pad's), the augs of a batch
within 1e-6, and a whole train batch with every option (EDT*ROI
sampling, the three augs, ppiw) against make_train_batch."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.ops.resize import resize2d as j_resize2d
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.data.synthetic import _cell_image

AUGS = dict(da_blur=True, da_blur_prob=0.7, da_blur_sigma=1.5,
            da_dot_bin_noise=True, da_dot_bin_noise_prob=0.7,
            da_add_gaus_noise=True, da_add_gaus_noise_prob=0.7,
            da_add_gaus_noise_std=0.05)


def _jax_block(km, h, w, area):
    """JAX's _block_mask draws for key km: (top, left, height, width)."""
    kr, kh, kw = jax.random.split(km, 3)
    ratio = jnp.clip(jax.random.normal(kr, ()) * 0.01 + area, 0.0, 1.0)
    bh = (h * ratio).astype(jnp.int32)
    bw = (w * ratio).astype(jnp.int32)
    ch = jax.random.randint(kh, (), 0, jnp.maximum(h - bh + 1, 1))
    cw = jax.random.randint(kw, (), 0, jnp.maximum(w - bw + 1, 1))
    return [int(ch), int(cw), int(bh), int(bw)]


def jax_aug_draws(k_aug, ls, c, cfg):
    """One sample's local-aug choices as JAX's _apply_local_augs draws
    them from k_aug: {name: (apply, box, field)}."""
    kb, kd, kg = jax.random.split(k_aug, 3)
    out = {}
    if cfg.da_blur and cfg.da_blur_area > 0:
        ka, km, kinv = jax.random.split(kb, 3)
        out['blur'] = (bool(jax.random.uniform(ka, ()) < cfg.da_blur_prob),
                       _jax_block(km, ls, ls, cfg.da_blur_area),
                       bool(jax.random.uniform(kinv, ()) >= 0.98))
    if cfg.da_dot_bin_noise and cfg.da_dot_bin_noise_area > 0:
        ka, km, kn = jax.random.split(kd, 3)
        keep = jax.random.bernoulli(kn, 1.0 - cfg.da_dot_bin_noise_p,
                                    (ls, ls, 1))
        out['dot'] = (
            bool(jax.random.uniform(ka, ()) < cfg.da_dot_bin_noise_prob),
            _jax_block(km, ls, ls, cfg.da_dot_bin_noise_area),
            np.asarray(keep, np.float32).transpose(2, 0, 1))
    if cfg.da_add_gaus_noise and cfg.da_add_gaus_noise_area > 0:
        ka, km, kn = jax.random.split(kg, 3)
        z = jax.random.normal(kn, (ls, ls, c), jnp.float32)
        out['gaus'] = (
            bool(jax.random.uniform(ka, ()) < cfg.da_add_gaus_noise_prob),
            _jax_block(km, ls, ls, cfg.da_add_gaus_noise_area),
            np.asarray(z).transpose(2, 0, 1))
    return out


def _stack_augs(per_sample):
    """Per-sample aug draws -> the port's BlockAug fields."""
    out = {}
    for name in per_sample[0]:
        apply, box, field = zip(*(d[name] for d in per_sample))
        field = torch.tensor(field) if name == 'blur' else \
            torch.from_numpy(np.stack(field))
        out[name] = TP.BlockAug(torch.tensor(apply), torch.tensor(box),
                                field)
    return out


def jax_batch_draws(key, hr, lr, idxs, cfg):
    """Every draw of JAX's make_train_batch for `key`
    (pipeline.py:250-292): per sample fold_in(key, i), split 3 into the
    origin's, the mode's and the augs' keys; a ROI / EDT origin from
    JAX's own _sample_origin on the sample's pre-upscale."""
    x0, y0, mode, augs = [], [], [], []
    hs, ls, c = cfg.h_size, cfg.l_size, hr.shape[-1]
    for n, i in enumerate(np.asarray(idxs)):
        k_orig, k_mode, k_aug = jax.random.split(jax.random.fold_in(key, n),
                                                 3)
        if cfg.sample_tr_patch == JC.SAMPLE_UNIF:
            hi = max(0, hr.shape[1] - hs) + 1
            kx, ky = jax.random.split(k_orig)
            a, b = (jax.random.randint(kx, (), 0, hi),
                    jax.random.randint(ky, (), 0, hi))
        else:
            l2h = j_resize2d(jnp.asarray(lr[i], jnp.float32).transpose(
                2, 0, 1), hr.shape[1:3])
            a, b = JP._sample_origin(
                k_orig, jnp.round(jnp.clip(l2h, 0, 255))[0], cfg)
        x0.append(int(a))
        y0.append(int(b))
        mode.append(int(jax.random.randint(k_mode, (), 0, 8)))
        augs.append(jax_aug_draws(k_aug, ls, c, cfg))
    return TP.Draws(torch.tensor(x0), torch.tensor(y0), torch.tensor(mode),
                    **(_stack_augs(augs) if augs[0] else {}))


def test_block_mask_matches_jax():
    for s in range(6):
        km = jax.random.key(s)
        box = _jax_block(km, 16, 16, 0.3 + 0.1 * s)
        ref = np.asarray(JP._block_mask(km, 16, 16, 0.3 + 0.1 * s))[..., 0]
        got = TP._block_mask(torch.tensor([box]), 16, 16)[0, 0].numpy()
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 0


@pytest.mark.parametrize('sigma,side', [(1.0, 16), (1.5, 8), (4.0, 16),
                                        (2.0, 3)])
def test_gauss_blur_matches_jax(sigma, side):
    """A radius int(4 sigma + 0.5) up to 16 on a side of 16 (and 9 on a
    side of 3): JAX's reflect pad repeats its reflection."""
    img = np.random.default_rng(0).uniform(0, 1, (side, side, 2)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JP._gauss_blur, static_argnums=1)(
        jnp.asarray(img), sigma)).transpose(2, 0, 1)
    got = TP._gauss_blur(torch.from_numpy(img.transpose(2, 0, 1)[None]
                                          .copy()), sigma)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize('extra', [{}, dict(da_blur_prob=1.0,
                                             da_blur_area=0.6),
                                    dict(da_dot_bin_noise_p=0.2,
                                         da_add_gaus_noise_area=1.0)])
def test_apply_local_augs_matches_jax(extra):
    cfg_kw = dict(scale=4, h_size=48, **{**AUGS, **extra})
    cfg_j, cfg_t = JP.PipeConfig(**cfg_kw), TP.PipeConfig(**cfg_kw)
    r = np.random.default_rng(1)
    n, ls = 12, 12
    lr = r.uniform(0, 1, (n, ls, ls, 1)).astype(np.float32)
    keys = [jax.random.key(100 + i) for i in range(n)]
    f = jax.jit(lambda k, x: JP._apply_local_augs(k, x, cfg_j))
    ref = np.stack([np.asarray(f(k, jnp.asarray(x))).transpose(2, 0, 1)
                    for k, x in zip(keys, lr)])
    augs = _stack_augs([jax_aug_draws(k, ls, 1, cfg_j) for k in keys])
    assert augs['blur'].apply.any() and augs['gaus'].apply.any()
    draws = TP.Draws(*(torch.zeros(n, dtype=torch.long),) * 3, **augs)
    got = TP._apply_local_augs(torch.from_numpy(lr.transpose(0, 3, 1, 2)
                                                .copy()), draws, cfg_t)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert np.abs(ref - lr.transpose(0, 3, 1, 2)).max() > 0.01


def test_port_aug_draws_shapes_and_rates():
    cfg = TP.PipeConfig(scale=4, h_size=64, **AUGS)
    d = TP.draw(torch.Generator().manual_seed(0), 4000, cfg, (128, 128))
    ls = 16
    assert abs(float(d.blur.apply.float().mean()) - 0.7) < 0.03
    assert abs(float(d.blur.field.float().mean()) - 0.02) < 0.01
    assert abs(float(d.dot.field.mean()) - 0.5) < 0.01
    assert d.gaus.field.shape == (4000, 1, ls, ls)
    box = d.dot.box
    assert int(box[:, 2].min()) >= 0 and int((box[:, 0] + box[:, 2]).max()) \
        <= ls
    assert set(box[:, 2].tolist()) <= {3, 4, 5}
    off = TP.draw(torch.Generator(), 3, TP.PipeConfig(scale=4, h_size=64),
                  (128, 128))
    assert off.blur is off.dot is off.gaus is None


@pytest.mark.parametrize('st', [JC.SAMPLE_UNIF, JC.SAMPLE_EDTXROI])
def test_train_batch_with_every_option_matches_jax(st):
    """EDT*ROI (or uniform) origins, the dihedral mode, the three augs
    and ppiw: JAX's draws fed to the port's assemble. l_im within 1e-6,
    h_im and the per-pixel weights exactly, the uint8-quantized l_to_h
    of the augmented LR within one level and exact at 99.9%."""
    rng = np.random.default_rng(2)
    hr = np.stack([_cell_image(rng, 64) for _ in range(4)])[..., None]
    lr = np.ascontiguousarray(hr[:, ::4, ::4])
    idxs = np.array([0, 3, 1, 2, 2, 0], np.int32)
    kw = dict(scale=4, h_size=32, sample_tr_patch=st, ppiw=True, **AUGS)
    cfg_j, cfg_t = JP.PipeConfig(**kw), TP.PipeConfig(**kw)
    table = JP.per_color_weights(hr, 0.001)
    key = jax.random.key(9)
    bj = JP.make_train_batch(jnp.asarray(hr), jnp.asarray(lr),
                             jnp.asarray(idxs), key, cfg_j,
                             jnp.asarray(table))
    draws = jax_batch_draws(key, hr, lr, idxs, cfg_j)
    bt = TP.assemble(torch.from_numpy(hr), torch.from_numpy(lr),
                     torch.from_numpy(idxs), draws, cfg_t,
                     torch.from_numpy(table))
    np.testing.assert_allclose(bt['l_im'].numpy(), np.asarray(bj['l_im']),
                               rtol=0, atol=1e-6)
    for k in ('h_im', 'h_per_pixel_weight'):
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    d = np.abs(bt['l_to_h_img'].numpy() - np.asarray(bj['l_to_h_img']))
    assert d.max() <= 1.0 / 255 + 1e-7 and (d == 0).mean() >= 0.999
