"""The port's initializers against the JAX package's, for each zoo net at
its full default width (x8, one channel): the two packages draw from
different generators, so each leaf is held by its distribution. A leaf
that JAX fills without drawing (zeros, ones, PReLU's 0.25, MSLapSRN's
bilinear filters) must be equal; a drawn leaf of n values within 5
standard errors in mean and standard deviation (a wrong fan moves the
std by sqrt(2) or more) and, where JAX's draw is bounded (max |w| within
2.5 std: a uniform or a normal truncated at 2 std), within max(3%,
5/sqrt(n)) in max |w| (a uniform in place of a truncated normal moves
it by 1.97 / 1.73). ENLCN's projection buffer (drawn per call in JAX,
held by the port) is held the same way. Then the output scale at init
on one input (ACT's outputs reach ~1e3 at init, OmniSR's ~30): the
output std of three draws of each package's init, the port's seeds
0-2 and JAX's seed 0 with each leaf's values shuffled twice (another
draw of an i.i.d. init), whose ranges, each widened by 1.5x, must
overlap: a deep ReLU net's output scale at init varies by 2x from draw
to draw (VDSR), a wrong init moves it by orders of magnitude. DRRN
applies its shared recursive unit 25 times, which makes its output
scale heavy-tailed (over 12 draws at this input: 0.83 to 61 in JAX,
1.3 to 535 in the port; a wrong fan would move it by sqrt(2)^50): eight
draws on each side. NLSN takes a 12x12 input: its chunks of 144 need at
least 72 positions (JAX's NLSN raises below). JAX runs eagerly:
jit-compiling OmniSR's init takes minutes."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcaco2_tpu.config.net_defaults import init_net_g as j_init_net_g
from srcaco2_tpu.models import enlcn as JE
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu_torch import constants as TC
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.config.net_defaults import PORTED_NETS
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train.steps import model_outputs

ZOO = [n for n in PORTED_NETS if n != TC.SWINIR]
SCALE, LR_HW = 8, 8
# NLSN's chunks need 72 positions; DBPN (39 k12 projections of 64
# channels) and ProSR (three pyramid levels of dense blocks) run on 4x4
LR_OF = {TC.NLSN: 12, TC.DBPN: 4, TC.PROSR: 4}
# draws of each package's init whose output scales are compared
N_DRAWS = {TC.DRRN: 8}


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(nt):
    args = {'scale': SCALE, 'n_channels': 1,
            'h_size': SCALE * LR_OF.get(nt, LR_HW), 'amp': False,
            'color_min': 0, 'color_max': 255}
    args['netG'] = j_init_net_g({'net_type': nt}, args)
    return args


def _input(nt):
    lr_hw = LR_OF.get(nt, LR_HW)
    hw = SCALE * lr_hw if nt in (TC.SRCNN, TC.CSRCNN) else lr_hw
    return np.random.default_rng(0).uniform(
        0, 1, (1, 1, hw, hw)).astype(np.float32)


def _same_distribution(name, a, b):
    a, b = a.double().flatten(), b.double().flatten()
    if torch.equal(a, b):
        return
    n = a.numel()
    sa, sb = float(a.std()), float(b.std())
    assert sa > 0 and sb > 0, (name, sa, sb)
    # standard errors of a mean and of a std (kurtosis <= 3 here) for
    # the difference of two independent samples of n
    se_mean = math.sqrt(2.0 / n) * max(sa, sb)
    se_std = math.sqrt(2.0 * 2.0 / (4.0 * n))
    assert abs(float(a.mean() - b.mean())) <= 5 * se_mean, name
    assert abs(sb / sa - 1.0) <= max(5 * se_std, 1e-3), (name, sa, sb)
    ma, mb = float(a.abs().max()), float(b.abs().max())
    if ma <= 2.5 * sa:
        assert abs(mb / ma - 1.0) <= max(0.03, 5 / math.sqrt(n)), \
            (name, ma, mb)


@pytest.mark.parametrize('nt', ZOO)
def test_init_matches_jax(nt):
    args = _args(nt)
    jm = j_define_g(args)
    x = _input(nt)
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, v['params'])
    n = N_DRAWS.get(nt, 3)
    j_std = []
    for shuffle in (None, *range(1, n)):
        p = params
        if shuffle is not None:
            rng = np.random.default_rng(shuffle)
            p = jax.tree.map(
                lambda a: rng.permutation(a.ravel()).reshape(a.shape), p)
        y = jm.apply({**v, 'params': p}, jnp.asarray(x), train=False)
        j_std.append(float(jnp.std(y['out'] if isinstance(y, dict)
                                   else y)))
    t_std = []
    for seed in range(n - 1, -1, -1):
        tm = t_define_g(args, 'cpu', seed=seed)
        with torch.no_grad():
            out = model_outputs(tm(torch.from_numpy(x)))['out']
        t_std.append(float(out.std(correction=0)))
    assert (max(t_std) * 1.5 >= min(j_std)
            and max(j_std) * 1.5 >= min(t_std)), (j_std, t_std)
    proj = None
    if nt == TC.ENLCN:
        nb, c4 = next(b.shape for k, b in tm.named_buffers()
                      if k.endswith('proj'))
        proj = np.asarray(JE.gaussian_orthogonal_random_matrix(
            jax.random.key(42), nb, c4))
    carried = flax_to_torch(params, tm, projection=proj)
    own = dict(tm.named_parameters()) | dict(tm.named_buffers())
    assert set(carried) <= set(own)
    for k, a in carried.items():
        _same_distribution(k, a, own[k].detach())
