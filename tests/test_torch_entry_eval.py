"""The port's fast_eval against the JAX package's, image by image (PSNR
within 1e-3 dB, SSIM within 1e-5, full and ROI): the bicubic baseline,
and a tiny fused SwinIR with JAX's params through bridge.flax_to_torch,
at a size that takes the tiled path (LR 32x32, multiples of the 16-pixel
tile) and at one that takes the windowed path (LR 24x24). A non-finite
output raises FloatingPointError in both."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.data import dataset as JD
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import evaluator as JE
from srcaco2_tpu.train.steps import make_eval_forward as j_eval_forward
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.data import dataset as TD
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import evaluator as TE
from srcaco2_tpu_torch.train.steps import make_eval_forward as t_eval_forward

NET = dict(upscale=2, window_size=8, embed_dim=16, depths=(2, 2),
           num_heads=(2, 2), upsampler='pixelshuffle', in_chans=1,
           mlp_ratio=2.0)
TOL = {'psnr': 1e-3, 'psnr_y': 1e-3, 'ssim': 1e-5}


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    """Two torch threads: these tests run many tiny ops, which slow down
    by an order of magnitude when six test workers each start one
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args():
    return {'scale': 2, 'eval_over_roi_also': True,
            'eval_over_roi_also_ths': JC.ROI_THRESH, 'is_master': True,
            'device': 'cpu'}


@pytest.fixture(scope='module', params=[64, 48], ids=['lr32', 'lr24'])
def val_split(request, tmp_path_factory):
    """(JAX dataset, port dataset) of a 3-image synthetic val split at
    x2: HR 64 (LR 32, tiled path) or 48 (LR 24, windowed path)."""
    root = str(tmp_path_factory.mktemp('val'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=1,
                                   n_val=3, n_test=1, size=request.param)
    dargs = {'data_root': root, 'splits_root': root, 'scale': 2,
             'n_channels': 1, 'myseed': 0, 'inter_low_th': 7.0,
             'inter_low_sigma': 6.0, 'num_workers': 2}
    return (JD.load_dataset(dargs, names[1], 'eval'),
            TD.load_dataset(dargs, names[1], 'eval'))


def _compare(jperf, tperf):
    assert tperf['n'] == jperf['n'] == 3
    for det in ('details', 'roi_details'):
        assert sorted(tperf[det]) == sorted(jperf[det])
        for img, jm in jperf[det].items():
            for m, tol in TOL.items():
                assert abs(tperf[det][img][m] - jm[m]) <= tol, \
                    (det, img, m, tperf[det][img][m], jm[m])
    for scope in ('full', 'roi'):
        for m, tol in TOL.items():
            assert abs(tperf[scope][m] - jperf[scope][m]) <= tol


def test_bicubic_fast_eval_matches_jax(val_split):
    jds, tds = val_split
    jperf = JE.fast_eval(JE.make_interpolate_forward(2, 'bicubic'), None,
                         jds, _args(), 2, JC.VALIDSET)
    tperf = TE.fast_eval(TE.make_interpolate_forward(2, 'bicubic'), None,
                         tds, _args(), 2, JC.VALIDSET)
    _compare(jperf, tperf)


def _swinir_pair():
    jm = JSwinIR(fused_blocks=True, fused_mode='interpret', **NET)
    init = JSwinIR(fused_blocks=True, fused_mode='never', **NET)
    p = jax.jit(lambda k: init.init(k, jnp.zeros((1, 1, 8, 8)),
                                    train=False)['params'])(
        jax.random.key(0))
    pn = jax.tree.map(np.asarray, p)
    tm = TSwinIR(device='cpu', **NET)
    tm.load_state_dict(flax_to_torch(pn, tm))
    return jm, pn, tm


def test_swinir_fast_eval_matches_jax(val_split, tmp_path, monkeypatch):
    """The random-weight net's SSIM is negative on some images (LR 32):
    with SRCACO2_FAST_SWEEP=1 both evaluators log it and go on, as the
    JAX package's few-epoch sweeps need; without it both stop."""
    jds, tds = val_split
    jm, pn, tm = _swinir_pair()
    jfwd, fwd = j_eval_forward(jm, 'SwinIR', 2), t_eval_forward(tm,
                                                                'SwinIR', 2)
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')
    jperf = JE.fast_eval(jfwd, pn, jds, _args(), 2, JC.VALIDSET)
    tperf = TE.fast_eval(fwd, None, tds, _args(), 2, JC.VALIDSET,
                         save_img_dir=str(tmp_path), nbr_to_plot=2)
    _compare(jperf, tperf)
    assert len(list(tmp_path.glob('*.png'))) == 2
    # the same weights passed as a state_dict, as the trainer passes the
    # best model, give the same numbers
    again = TE.fast_eval(fwd, tm.state_dict(), tds, _args(), 2,
                         JC.VALIDSET)
    assert again['details'] == tperf['details']
    negative = any(v < 0 for det in ('details', 'roi_details')
                   for d in jperf[det].values() for v in d.values())
    assert negative == (tds.l_size == 32)
    monkeypatch.delenv('SRCACO2_FAST_SWEEP')
    for fast_eval, f, p, ds in ((JE.fast_eval, jfwd, pn, jds),
                                (TE.fast_eval, fwd, None, tds)):
        if negative:
            with pytest.raises(FloatingPointError, match='negative'):
                fast_eval(f, p, ds, _args(), 2, JC.VALIDSET)
        else:
            fast_eval(f, p, ds, _args(), 2, JC.VALIDSET)


def test_non_finite_output_raises(val_split):
    jds, tds = val_split

    def j_nan(params, batch):
        return jnp.full(batch['h_im'].shape, jnp.nan)

    def t_nan(params, batch):
        return torch.full(batch['h_im'].shape, float('nan'))
    with pytest.raises(FloatingPointError):
        JE.fast_eval(j_nan, None, jds, _args(), 2, JC.VALIDSET)
    with pytest.raises(FloatingPointError):
        TE.fast_eval(t_nan, None, tds, _args(), 2, JC.VALIDSET)
