"""The 13 loss terms of the port beyond l1 / l2 / SSIM / ce against the
JAX package's (losses/master.py, ops.py, elb.py), on the same numpy
inputs from a seed, JAX jitted: l2sum, charbonnier, boundpred (ELB),
local_moments, the derivative terms and their norm_ forms, hist (KL,
BH, 1, 2), kde (BH, 1, 2) and w_sparsity, with and without
use_residuals. Held: the f32 value within 1e-6 (absolute, or relative
for values above 1) and the grad of the prediction (of the residual, of
the params for w_sparsity) within 1e-5 of its largest entry. Also the
ELB's two branches and update_t, the non-finite grads of the norm_
terms at a zero derivative vector (kept from jnp.linalg.norm), and the
TypeError of the convolution terms on a bf16 prediction."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.losses import elb as JELB
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.losses import elb as TELB
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


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


RESIDUAL_TERMS = ['l2sum', 'charbonnier', 'boundpred', 'local_moments',
                  'img_grad', 'norm_img_grad', 'laplace', 'norm_laplace',
                  'loc_var', 'norm_loc_var']
CONV_TERMS = ['local_moments', 'img_grad', 'norm_img_grad', 'laplace',
              'norm_laplace', 'loc_var', 'norm_loc_var']
NORM_TERMS = ['norm_img_grad', 'norm_laplace', 'norm_loc_var']
CASES = (
    [(t, {}, res) for t in RESIDUAL_TERMS for res in (False, True)]
    + [('local_moments', {'local_moments_ksz': '5_3'}, False),
       ('img_grad', {'img_grad_norm': JC.NORM1}, False),
       ('norm_laplace', {'norm_laplace_type': JC.NORM1}, False),
       ('loc_var', {'loc_var_ksz': 5, 'loc_var_norm': JC.NORM0EXP}, False),
       ('boundpred', {'boundpred_restore_range': False,
                      'boundpred_eps': 0.05}, False)]
    + [('hist', {'hist_metric': m}, False)
       for m in (JC.KL, JC.BH, JC.NORM1, JC.NORM2)]
    + [('kde', {'kde_metric': m}, False) for m in (JC.BH, JC.NORM1,
                                                   JC.NORM2)]
    + [('w_sparsity', {'w_sparsity_lambda': 0.5}, False)])


def _ids(case):
    term, extra, res = case
    return '-'.join([term] + [str(v) for v in extra.values()]
                    + (['res'] if res else []))


def _inputs(seed=0, shape=(2, 1, 12, 16)):
    """A prediction in [0, 1], a target on the uint8 grid, a bicubic
    stand-in and a residual; target and target - bicubic are flat on a
    block (local_moments' smooth filter)."""
    r = np.random.default_rng(seed)
    p = r.uniform(0, 1, shape).astype(np.float32)
    y = (np.round(r.uniform(0, 1, shape) * 255) / 255).astype(np.float32)
    y[:, :, :5, :5] = 0.5
    xi = r.uniform(0, 1, shape).astype(np.float32)
    xi[:, :, :5, :5] = 0.25
    res = r.normal(0, 0.1, shape).astype(np.float32)
    return p, y, xi, res


def _params(seed=1):
    r = np.random.default_rng(seed)
    return {'a': r.normal(0, 0.01, (4, 6)).astype(np.float32),
            'b': r.normal(0, 0.01, (30,)).astype(np.float32)}


def _losses(term, extra):
    flags = {term: True, **extra}
    return (j_build_loss({**j_get_config(JC.SWINIR), **flags}),
            t_build_loss({**t_get_config(), **flags}))


def _value_and_grads(term, extra, res, elb_t=1.3, seed=0):
    """(JAX value, port value, JAX grad, port grad) of the term: the grad
    of the prediction (of the residual with use_residuals, of the params
    for w_sparsity)."""
    if res:
        extra = {**extra, f'{term}_use_residuals': True}
    jm, tm = _losses(term, extra)
    p, y, xi, r = _inputs(seed)
    par = _params()
    wrt = r if res else p
    diff = 'params' if term == 'w_sparsity' else 'x'

    def jfn(x, pp):
        out = {'out': jnp.asarray(p), 'x_interp': jnp.asarray(xi),
               'global_residual': x} if res else {'out': x}
        return jm(out, {'h_im': jnp.asarray(y)}, pp, 0, elb_t)[0]
    vj, gj = jax.jit(jax.value_and_grad(
        jfn, argnums=1 if diff == 'params' else 0))(
        jnp.asarray(wrt), {k: jnp.asarray(v) for k, v in par.items()})
    x = torch.from_numpy(wrt).requires_grad_()
    tpar = {k: torch.from_numpy(v).requires_grad_() for k, v in par.items()}
    out = {'out': torch.from_numpy(p), 'x_interp': torch.from_numpy(xi),
           'global_residual': x} if res else {'out': x}
    vt, hold = tm(out, {'h_im': torch.from_numpy(y)}, tpar, 0,
                  torch.tensor(elb_t))
    assert tm.names == [term, 'total']
    if diff == 'params':
        gt = torch.autograd.grad(vt, list(tpar.values()))
        gj = np.concatenate([np.asarray(gj[k]).ravel() for k in par])
        gt = np.concatenate([g.numpy().ravel() for g in gt])
    else:
        gt = torch.autograd.grad(vt, x)[0].numpy()
        gj = np.asarray(gj)
    return float(vj), float(vt.detach()), gj, gt


@pytest.mark.parametrize('case', CASES, ids=_ids)
def test_term_value_and_grad_match_jax(case):
    term, extra, res = case
    vj, vt, gj, gt = _value_and_grads(term, extra, res)
    assert np.isfinite(vj)
    assert abs(vt - vj) <= 1e-6 * max(1.0, abs(vj)), (vt, vj)
    assert np.isfinite(gj).all() and np.abs(gj).max() > 0
    assert np.abs(gt - gj).max() <= 1e-5 * np.abs(gj).max() + 1e-12


@pytest.mark.parametrize('t', [0.5, 1.0, 3.0])
def test_elb_branches_and_update_t_match_jax(t):
    """Constraint values on both sides of -1/t^2 (the log branch and the
    linear extension), value and grad; and update_t's capped raise."""
    fx = np.linspace(-5.0, 2.0, 57).astype(np.float32)
    ct = -1.0 / (t * t)
    assert (fx <= ct).any() and (fx > ct).any()
    vj, gj = jax.value_and_grad(lambda f: JELB.elb(f, t))(jnp.asarray(fx))
    x = torch.from_numpy(fx).requires_grad_()
    vt = TELB.elb(x, t)
    gt, = torch.autograd.grad(vt, x)
    vt = float(vt.detach())
    assert abs(vt - float(vj)) <= 1e-6 * max(1.0, abs(float(vj)))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    tj, tt = jnp.float32(t), torch.tensor(t, dtype=torch.float32)
    for _ in range(400):
        tj, tt = JELB.update_t(tj, 1.01, 10.0), TELB.update_t(tt, 1.01, 10.0)
        assert float(tt) == float(tj)
    assert float(tt) == 10.0


@pytest.mark.parametrize('term', NORM_TERMS)
def test_norm_terms_nan_grad_at_a_zero_vector(term):
    """A prediction flat on a block: its derivative vectors there are 0,
    and the vector norm's gradient is NaN on both sides (JAX's
    jnp.linalg.norm; torch.linalg.norm would give 0), so the train step
    skips."""
    jm, tm = _losses(term, {})
    p, y, _, _ = _inputs()
    p[:, :, 3:9, 3:9] = 0.25

    def jfn(x):
        return jm({'out': x}, {'h_im': jnp.asarray(y)})[0]
    vj, gj = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(p))
    x = torch.from_numpy(p).requires_grad_()
    vt, _ = tm({'out': x}, {'h_im': torch.from_numpy(y)})
    gt, = torch.autograd.grad(vt, x)
    assert np.isfinite(float(vj)) and np.isfinite(float(vt.detach()))
    assert not np.isfinite(np.asarray(gj)).all()
    assert not torch.isfinite(gt).all()
    # the same places: every grad is NaN, as the NaN spreads through the
    # convolution's transpose
    np.testing.assert_array_equal(np.isfinite(np.asarray(gj)),
                                  torch.isfinite(gt).numpy())


@pytest.mark.parametrize('term', CONV_TERMS)
def test_conv_terms_refuse_bf16_as_jax(term):
    """lax.conv_general_dilated will not mix a bf16 prediction with the
    f32 kernels, and the port raises the same TypeError rather than cast;
    the histogram terms take bf16 (promoted to f32 by their centers)."""
    jm, tm = _losses(term, {})
    p, y, _, _ = _inputs()
    with pytest.raises(TypeError):
        jm({'out': jnp.asarray(p, jnp.bfloat16)}, {'h_im': jnp.asarray(y)})
    with pytest.raises(TypeError):
        tm({'out': torch.from_numpy(p).bfloat16()},
           {'h_im': torch.from_numpy(y)})


@pytest.mark.parametrize('term', ['hist', 'kde'])
def test_distribution_terms_take_bf16(term):
    jm, tm = _losses(term, {})
    p, y, _, _ = _inputs()
    vj, _ = jm({'out': jnp.asarray(p, jnp.bfloat16)}, {'h_im': jnp.asarray(y)})
    vt, _ = tm({'out': torch.from_numpy(p).bfloat16()},
               {'h_im': torch.from_numpy(y)})
    assert vt.dtype == torch.float32
    assert abs(float(vt) - float(vj)) <= 1e-6 * max(1.0, abs(float(vj)))
