"""The training slice's plain-PyTorch parts of the port against the JAX
package: resize, the batch pipeline (JAX's own draws fed to the port's
`assemble`), train-time SSIM and MasterLoss, the LR schedules, the
optimizer chain against optax, EMA and all_finite, and the bf16
convolution's rounding points."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses import ops as JL
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models.blocks import Conv as JConv
from srcaco2_tpu.ops import resize as JR
from srcaco2_tpu.train import schedule as JS
from srcaco2_tpu.train import state as JST
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.losses import ops as TL
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models.blocks import Conv as TConv
from srcaco2_tpu_torch.ops import resize as TR
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train import state as TST


def jax_draws(key, n, hr_h, h_size):
    """The origins and modes JAX's make_train_batch draws for `key`
    (pipeline.py:250-275): fold_in(key, i), split 3, then randint."""
    x0, y0, mode = [], [], []
    hi = max(0, hr_h - h_size) + 1
    for i in range(n):
        k_orig, k_mode, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        kx, ky = jax.random.split(k_orig)
        x0.append(int(jax.random.randint(kx, (), 0, hi)))
        y0.append(int(jax.random.randint(ky, (), 0, hi)))
        mode.append(int(jax.random.randint(k_mode, (), 0, 8)))
    return TP.Draws(*(torch.tensor(v) for v in (x0, y0, mode)))


# ------------------------------------------------------------ resize

@pytest.mark.parametrize('method', [JR.TORCH_BICUBIC, JR.MATLAB_BICUBIC,
                                    JR.BILINEAR, JR.NEAREST])
@pytest.mark.parametrize('antialias,align', [(False, False), (True, False),
                                             (False, True)])
def test_resize2d_matches_jax(method, antialias, align):
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 12, 20)).astype(
        np.float32)
    for out in [(24, 40), (5, 7), (12, 9)]:
        ref = np.asarray(JR.resize2d(jnp.asarray(x), out, method, antialias,
                                     align))
        got = TR.resize2d(torch.from_numpy(x), out, method, antialias,
                          align).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)
        np.testing.assert_array_equal(
            TR.resize_weights(12, out[0], method, antialias, align),
            JR.resize_weights(12, out[0], method, antialias, align))
    np.testing.assert_allclose(
        TR.interpolate(torch.from_numpy(x), 2).numpy(),
        np.asarray(JR.interpolate(jnp.asarray(x), 2)), atol=1e-6)
    np.testing.assert_allclose(
        TR.imresize_matlab(torch.from_numpy(x), 0.5).numpy(),
        np.asarray(JR.imresize_matlab(jnp.asarray(x), 0.5)), atol=1e-6)


# ---------------------------------------------------------- pipeline

def _stacks(n=4, hr=64, scale=4, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, 256, (n, hr, hr, 1), dtype=np.uint8),
            r.integers(0, 256, (n, hr // scale, hr // scale, 1),
                       dtype=np.uint8))


@pytest.mark.parametrize('aligned', [False, True])
def test_assemble_with_jax_draws_matches_make_train_batch(aligned):
    """JAX's draws fed to the port's assemble: the crops (with the
    misalignment quirk unless aligned) and dihedral modes agree exactly;
    the uint8-quantized bicubic l_to_h is within one level, and exact
    on at least 99.9% of the pixels."""
    hr, lr = _stacks()
    cfg_j = JP.PipeConfig(scale=4, h_size=32, aligned_crops=aligned)
    cfg_t = TP.PipeConfig(scale=4, h_size=32, aligned_crops=aligned)
    idxs = np.array([0, 3, 1, 2, 2, 0, 1, 3] * 2, np.int32)
    key = jax.random.key(7)
    bj = JP.make_train_batch(jnp.asarray(hr), jnp.asarray(lr),
                             jnp.asarray(idxs), key, cfg_j)
    draws = jax_draws(key, len(idxs), hr.shape[1], 32)
    assert len(set(draws.mode.tolist())) > 1
    bt = TP.assemble(torch.from_numpy(hr), torch.from_numpy(lr),
                     torch.from_numpy(idxs), draws, cfg_t)
    for k in ('l_im', 'h_im'):
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    d = np.abs(bt['l_to_h_img'].numpy() - np.asarray(bj['l_to_h_img']))
    assert d.max() <= 1.0 / 255 + 1e-7
    assert (d == 0).mean() >= 0.999


def test_port_draws_range_and_modes():
    cfg = TP.PipeConfig(scale=4, h_size=32)
    gen = torch.Generator().manual_seed(0)
    d = TP.draw(gen, 4096, cfg, (64, 64))
    for v in (d.x0, d.y0):
        assert int(v.min()) >= 0 and int(v.max()) <= 64 - 32
    assert sorted(set(d.mode.tolist())) == list(range(8))
    hr, lr = _stacks()
    b = TP.make_train_batch(torch.from_numpy(hr), torch.from_numpy(lr),
                            torch.zeros(5, dtype=torch.int32), gen, cfg)
    assert b['l_im'].shape == (5, 1, 8, 8) and b['h_im'].shape == \
        (5, 1, 32, 32)


def test_unported_pipeline_options_raise():
    """The pipeline options that raised NotImplementedError before they
    were ported now draw their choices; ROI sampling without the origin
    weights raises. The defaults leave every option off."""
    for kw in (dict(da_blur=True), dict(ppiw=True),
               dict(da_dot_bin_noise=True, da_add_gaus_noise=True)):
        d = TP.draw(torch.Generator(), 2, TP.PipeConfig(4, 32, **kw),
                    (64, 64))
        assert d.x0.shape == (2,)
    assert d.dot is not None and d.gaus is not None and d.blur is None
    with pytest.raises(ValueError, match='weights'):
        TP.draw(torch.Generator(), 2,
                TP.PipeConfig(4, 32, sample_tr_patch=JC.SAMPLE_ROI),
                (64, 64))
    args = t_get_config()
    args.update(scale=4, h_size=32, n_channels=1)
    assert TP.from_args(args) == TP.PipeConfig(scale=4, h_size=32)


def test_eval_batch_matches_jax():
    hr, lr = _stacks()
    idxs = np.array([2, 0], np.int32)
    bj = JP.make_eval_batch(jnp.asarray(hr), jnp.asarray(lr),
                            jnp.asarray(idxs))
    bt = TP.make_eval_batch(torch.from_numpy(hr), torch.from_numpy(lr),
                            torch.from_numpy(idxs))
    # the jitted JAX division by 255 may round differently by one ulp:
    # compare the uint8 levels
    def lv(a):
        return np.round(np.asarray(a, np.float64) * 255)
    for k in ('l_im', 'h_im'):
        np.testing.assert_array_equal(lv(bt[k]), lv(bj[k]))
    d = np.abs(lv(bt['l_to_h_img']) - lv(bj['l_to_h_img']))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


# -------------------------------------------------------------- loss

def test_ssim_and_master_loss_match_jax():
    r = np.random.default_rng(1)
    p = r.uniform(0, 1, (3, 1, 16, 24)).astype(np.float32)
    y = r.uniform(0, 1, (3, 1, 16, 24)).astype(np.float32)
    np.testing.assert_allclose(
        TL.ssim_train(torch.from_numpy(p), torch.from_numpy(y), 19).numpy(),
        np.asarray(JL.ssim_train(jnp.asarray(p), jnp.asarray(y), 19)),
        atol=1e-6)
    flags = dict(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=19,
                 l1=True, l1_lambda=0.5)
    ja = {**j_get_config(JC.SWINIR), **flags}
    ta = {**t_get_config(), **flags}
    tot_j, hold_j = j_build_loss(ja)({'out': jnp.asarray(p)},
                                     {'h_im': jnp.asarray(y)})
    mt = t_build_loss(ta)
    tot_t, hold_t = mt({'out': torch.from_numpy(p)},
                       {'h_im': torch.from_numpy(y)})
    assert mt.names == ['l1', 'l2', 'ssim', 'total']
    for k in mt.names:
        np.testing.assert_allclose(float(hold_t[k]), float(hold_j[k]),
                                   atol=1e-6)
    # charbonnier, unported before, now builds and matches JAX
    cj, hj = j_build_loss({**ja, 'charbonnier': True})(
        {'out': jnp.asarray(p)}, {'h_im': jnp.asarray(y)})
    ct, ht = t_build_loss({**ta, 'charbonnier': True})(
        {'out': torch.from_numpy(p)}, {'h_im': torch.from_numpy(y)})
    np.testing.assert_allclose(float(ht['charbonnier']),
                               float(hj['charbonnier']), atol=1e-6)


# --------------------------------------------------- schedule, optim

def _train_cfg(**kw):
    tr = dict(j_get_config(JC.SWINIR)['train'])
    tr.update(kw)
    return tr


@pytest.mark.parametrize('tr', [
    _train_cfg(G_scheduler_type=JC.MULTISTEPLR, G_scheduler_milestones=[3, 7],
               G_scheduler_warmup=4),
    _train_cfg(G_scheduler_type=JC.MYSTEPLR, G_scheduler_step_size=3,
               G_scheduler_min_lr=4e-5, G_scheduler_warmup=4),
    _train_cfg()])
def test_schedule_matches_jax(tr):
    js, ts = JS.build_schedule(tr), TS.build_schedule(tr)
    for n in range(14):
        np.testing.assert_allclose(
            float(ts(torch.tensor(n, dtype=torch.int32))),
            float(js(jnp.int32(n))), rtol=1e-6)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {'a': r.normal(0, 1, (3, 4)).astype(np.float32),
            'b': r.normal(0, 1, (5,)).astype(np.float32)}


def _adam_of(opt_state):
    return next(s for s in opt_state if hasattr(s, 'mu'))


@pytest.mark.parametrize('tr', [
    _train_cfg(),                                            # wd + Adam
    _train_cfg(G_optimizer_clipgrad=0.5, G_optimizer_amsgrad=True,
               G_scheduler_type=JC.MYSTEPLR, G_scheduler_step_size=2,
               G_scheduler_warmup=3),                        # clip, AMSGrad
    _train_cfg(G_optimizer_type=JC.SGD, G_optimizer_clipgrad=100.0)])
def test_optimizer_chain_matches_optax(tr):
    """Four updates from the same grads: the updates and the state
    (moments, AMSGrad max, SGD trace, counts) agree to 1e-6 relative."""
    jtx, ttx = JS.build_optimizer(tr), TS.build_optimizer(tr)
    params = _tree(0)
    js = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = ttx.init(tparams)
    for step in range(4):
        g = _tree(10 + step)
        uj, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            {k: jnp.asarray(v) for k, v in params.items()})
        ut, ts = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tparams)
        for k in params:
            ref = np.asarray(uj[k])
            np.testing.assert_allclose(ut[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
        if tr['G_optimizer_type'] == JC.ADAM:
            aj = _adam_of(js)
            assert int(ts['adam']['count']) == int(aj.count) == step + 1
            for f in aj._fields[1:]:
                for k in params:
                    np.testing.assert_allclose(
                        ts['adam'][f][k].numpy(),
                        np.asarray(getattr(aj, f)[k]), rtol=1e-6)
        else:
            tj = next(s for s in js if hasattr(s, 'trace'))
            for k in params:
                np.testing.assert_allclose(ts['trace']['trace'][k].numpy(),
                                           np.asarray(tj.trace[k]),
                                           rtol=1e-6)
        assert int(ts['schedule']['count']) == step + 1


def test_ema_and_all_finite_match_jax():
    a, b = _tree(1), _tree(2)
    ej = JST.ema_update({k: jnp.asarray(v) for k, v in a.items()},
                        {k: jnp.asarray(v) for k, v in b.items()}, 0.99)
    et = TST.ema_update({k: torch.from_numpy(v) for k, v in a.items()},
                        {k: torch.from_numpy(v) for k, v in b.items()}, 0.99)
    for k in a:
        np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]),
                                   rtol=1e-6)
    for bad in (None, np.nan, np.inf):
        t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
        j = {k: jnp.asarray(v) for k, v in a.items()}
        if bad is not None:
            t['b'][1] = bad
            j['b'] = j['b'].at[1].set(bad)
        assert bool(TST.all_finite(t)) == bool(JST.all_finite(j)) == \
            (bad is None)


# ------------------------------------------------------- bf16 conv

def test_bf16_conv_rounds_as_flax():
    """The convolution rounds to bf16 and then adds the bf16 bias, as
    flax nn.Conv(dtype=bf16) does: every output within one bf16 ulp of
    flax's (a bias added inside the convolution rounds once and misses
    this where the output cancels)."""
    r = np.random.default_rng(0)
    cin, cout = 16, 32
    x = r.normal(0, 1, (2, 12, 12, cin)).astype(np.float32)
    jm = JConv(cout, 3, dtype=jnp.bfloat16)
    kernel = jm.init(jax.random.key(0), jnp.asarray(x))['params'][
        'Conv_0']['kernel']
    bias = r.normal(0, 1, (cout,)).astype(np.float32)
    yj = np.asarray(jax.jit(lambda xx: jm.apply(
        {'params': {'Conv_0': {'kernel': kernel, 'bias': bias}}}, xx))(
        jnp.asarray(x)).astype(jnp.float32)).transpose(0, 3, 1, 2)
    tm = TConv(cin, cout, 3, dtype=torch.bfloat16)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(
            np.asarray(kernel).transpose(3, 2, 0, 1).copy()))
        tm.bias.copy_(torch.from_numpy(bias))
        yt = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert yt.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(yj), 2.0 ** -126)))
                  - 7)
    assert (np.abs(yt.float().numpy() - yj) <= ulp).all()
