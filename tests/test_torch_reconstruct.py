"""The reconstruct task and the experiment-tree tools of the port against
the JAX package, on the CPU at small sizes.

- The blur chain and the dataset mapping (fake: the blurred LR -> the LR
  at scale 1; real, eval only: the HR downscaled without noise on both
  sides): the same uint8 arrays, scale, ids and paths.
- One scale-1 train step of SwinIR (fused: the plain K1 / K2 against the
  Pallas kernels in interpret mode, f32), VDSR and SRCNN (JAX in
  float64, as tests/test_torch_zoo_train.py explains) from the same
  params and batch: the loss, the grads, the updated params and moments
  (the tolerances of tests/test_torch_train_step.py).
- A JAX reconstruct experiment (VDSR) and its params bridged into a
  port experiment: reevaluate_reconstruct (fake, and real on one image),
  reevaluate at sigma 0 and 20, noise_study and the eval_all sweep give
  JAX's PSNR / SSIM rows within 1e-5 (relative above 1), the
  interpolation floor included.
- `python -m srcaco2_tpu_torch.main --task reconstruct` and `.eval` on
  the CPU; restore_grid's captions against JAX's, and its ImportError
  without matplotlib.
"""
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.config.parser import get_args as j_get_args
from srcaco2_tpu.data import dataset as JD
from srcaco2_tpu.data import pipeline as JP
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models import cnn_pre as JCP
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import checkpoint as JCKPT
from srcaco2_tpu.train import schedule as JSCH
from srcaco2_tpu.train import steps as JST
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu.train.trainer import Experiment as JExperiment
from srcaco2_tpu_torch.bridge import flax_to_torch, optax_to_torch
from srcaco2_tpu_torch.config import parser as TPARSE
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.data import dataset as TD
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models import cnn_pre as TCP
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import schedule as TSCH
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step
from srcaco2_tpu_torch.train.trainer import Experiment as TExperiment

from test_torch_train_parts import jax_draws

METRICS = ('psnr', 'ssim')
ROW_TOL = 1e-5


@pytest.fixture(autouse=True)
def _f32_softmax(monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ds_args(root, **kw):
    return {'data_root': root, 'splits_root': root, 'scale': 2,
            'n_channels': 1, 'myseed': 0, 'use_interpolated_low': False,
            'inter_low_th': 7., 'inter_low_sigma': 6., 'num_workers': 2,
            'task': JC.RECONSTRUCT, **kw}


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('recon_synth'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=4,
                                   n_val=2, n_test=3, size=64)
    return root, names


# ------------------------------------------------------------ the data

def test_blur_chain_matches_jax():
    """The f32 chain within 1e-6 (XLA's and torch's sums differ in the
    last ulp), and the uint8 levels after round(x 255) equal: no pixel
    of these stacks sits within an ulp of a half level."""
    x = np.random.default_rng(0).integers(0, 256, (5, 24, 40, 1),
                                          dtype=np.uint8)
    j, t = JD.blur_true_lr(x, batch=2), TD.blur_true_lr(x, batch=2)
    assert t.shape == j.shape == x.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)

    def u8(a):
        return np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
    moved = int((u8(t) != u8(j)).sum())
    assert moved == 0, f'{moved} of {x.size} pixels moved by one level'


@pytest.mark.parametrize('rin,phase', [('fake', 'train'), ('fake', 'eval'),
                                       ('real', 'eval')])
def test_reconstruct_dataset_matches_jax(synth, rin, phase):
    root, names = synth
    args = _ds_args(root, reconstruct_input=rin)
    name = names[0] if phase == 'train' else names[2]
    j = JD.load_dataset(args, name, phase)
    t = TD.load_dataset(args, name, phase)
    assert t.scale == j.scale == 1
    np.testing.assert_array_equal(t.hr, j.hr)
    np.testing.assert_array_equal(t.lr, j.lr)
    assert t.lr.dtype == t.hr.dtype == np.uint8
    assert t.hr.shape == t.lr.shape == (len(t), 32, 32, 1)
    for f in ('name', 'phase', 'ids', 'h_paths', 'l_paths', 'lr_is_real'):
        assert getattr(t, f) == getattr(j, f), f
    if rin == 'real':
        np.testing.assert_array_equal(t.lr, t.hr)
    else:
        assert (t.lr != t.hr).mean() > 0.05
        assert t.h_paths == t.l_paths


def test_real_input_raises_in_a_train_phase(synth):
    root, names = synth
    args = _ds_args(root, reconstruct_input='real')
    with pytest.raises(AssertionError):
        JD.load_dataset(args, names[0], 'train')
    with pytest.raises(ValueError, match='eval-only'):
        TD.load_dataset(args, names[0], 'train')


# ------------------------------------------------------ the train step

_SWIN = dict(upscale=1, window_size=4, embed_dim=16, depths=(2, 2),
             num_heads=(2, 2), upsampler='pixelshuffledirect', in_chans=1,
             mlp_ratio=2.0)
# net: (JAX model, port model, JAX in float64); 8x8 patches (T = 64: the
# fused path for SwinIR)
NETS = {
    'SwinIR': (lambda: JSwinIR(fused_blocks=True, fused_mode='interpret',
                               **_SWIN),
               lambda: TSwinIR(device='cpu', **_SWIN), False),
    'VDSR': (lambda: JCP.VDSR(in_chans=1, upscale=1, dtype=jnp.float64),
             lambda: TCP.VDSR(in_chans=1, upscale=1, device='cpu'), True),
    'SRCNN': (lambda: JCP.SRCNN(in_chans=1, dtype=jnp.float64),
              lambda: TCP.SRCNN(in_chans=1, device='cpu'), True),
}


def _close(name, got, ref, tol=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max() + 1e-7, (name, err)


@pytest.mark.parametrize('nt', sorted(NETS))
def test_scale1_train_step_matches_jax(nt):
    """One step at scale 1 (hr and lr stacks on one grid, h_size 8):
    the loss and every holder value within 1e-5, the grads within 1e-4
    of max|g| (JAX's read from its first Adam moment), the new params
    within 1e-2 lr where the update is live, the new first moment."""
    jfn, tfn, x64 = NETS[nt]
    flags = dict(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=7,
                 scale=1, h_size=8, n_channels=1)
    ja, ta = {**j_get_config(), **flags}, {**t_get_config(), **flags}
    r = np.random.default_rng(4)
    hr = jnp.asarray(r.integers(0, 256, (4, 16, 16, 1)), jnp.uint8)
    lr = jnp.asarray(r.integers(0, 256, (4, 16, 16, 1)), jnp.uint8)
    idxs = jnp.asarray([3, 0], jnp.int32)
    key = jax.random.key(5)
    cfg = JP.PipeConfig(scale=1, h_size=8)
    with jax.enable_x64(x64):
        jbatch = JP.make_train_batch(hr, lr, idxs, jax.random.fold_in(key, 0),
                                     cfg)
        jm = jfn()
        pn = jax.tree.map(np.asarray, jax.jit(
            lambda k, t: jm.init(k, t, train=False)['params'])(
            jax.random.key(0), JST.net_input(nt, jbatch)))
        tx = JSCH.build_optimizer(ja['train'])
        js = JTrainState.create(pn, tx)
        jstep = JST.make_train_step(jm, j_build_loss(ja), tx, nt, cfg,
                                    steps_per_epoch=1000, donate=False)
        js2, jh, jok = jstep(js, hr, lr, idxs, key)
        draws = jax_draws(jax.random.fold_in(key, 0), 2, 16, 8)
    tm = tfn()
    b1 = float(ja['train']['G_optimizer_beta1'])
    wd = float(ja['train']['G_optimizer_wd'])
    adam = next(s for s in js2.opt_state if hasattr(s, 'mu'))
    mu = flax_to_torch(jax.tree.map(np.asarray, adam.mu), tm)
    p0 = flax_to_torch(pn, tm)
    gj = {k: mu[k] / (1 - b1) - wd * p0[k] for k in mu}
    tm.load_state_dict(flax_to_torch(pn, tm))
    ttx = TSCH.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), ttx)
    st.opt_state = optax_to_torch(jax.tree.map(np.asarray, js.opt_state),
                                  tm, st.opt_state)
    tmaster = t_build_loss(ta)
    tcfg = TP.PipeConfig(scale=1, h_size=8)
    hr_t, lr_t = (torch.from_numpy(np.array(a)) for a in (hr, lr))
    idxs_t = torch.from_numpy(np.array(idxs))
    batch = TP.assemble(hr_t, lr_t, idxs_t, draws, tcfg)
    assert batch['l_im'].shape == batch['h_im'].shape == (2, 1, 8, 8)
    _, _, pred, gt = loss_and_grads(tm, tmaster, nt, st.params, batch, 0,
                                    1.0)
    assert pred.shape == (2, 1, 8, 8)
    assert set(gt) == set(gj)
    for k in gt:
        _close(k, gt[k], gj[k])
    tstep = make_train_step(tm, tmaster, ttx, nt, tcfg, steps_per_epoch=1000)
    st, th, tok = tstep(st, hr_t, lr_t, idxs_t, draws)
    assert bool(tok) and bool(jok)
    assert set(th) == set(jh)
    for k in th:
        np.testing.assert_allclose(float(th[k]), float(jh[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    lr_ = float(ja['train']['G_optimizer_lr'])
    newp = flax_to_torch(jax.tree.map(np.asarray, js2.params), tm)
    for k, v in newp.items():
        live = np.abs(mu[k].numpy() / (1 - b1)) > 1e-5
        d = np.abs(st.params[k].detach().numpy() - v.numpy())
        assert d[live].max(initial=0) <= 1e-2 * lr_, k
        assert d.max(initial=0) <= 2.0 * lr_ + 1e-7, k
        _close(k, st.opt_state['adam']['mu'][k], mu[k])


# ------------------------------------------------ the experiment tools

def _argv(root, names, net='VDSR'):
    return ['--net_type', net, '--task', JC.RECONSTRUCT, '--scale', '2',
            '--h_size', '32', '--n_channels', '1', '--train_dsets', names[0],
            '--valid_dsets', names[1], '--test_dsets', names[2],
            '--data_root', root, '--splits_root', root, '--l2', 'True',
            '--max_epochs', '1', '--batch_size', '2', '--eval_bsize', '2',
            '--checkpoint_eval', '1.0', '--checkpoint_save', '1.0',
            '--eval_over_roi_also', 'True']


@pytest.fixture(scope='module')
def exps(synth, tmp_path_factory):
    """(JAX experiment dir, port experiment dir holding the same params
    through the bridge, test dataset name). The JAX experiment trains one
    epoch; the port's is built by the port's Experiment from the same
    flags (which makes the net scale-1) and written as main writes it."""
    root, names = synth
    base = tmp_path_factory.mktemp('recon_exps')
    jdir = str(base / 'jax' / 'exp')
    args = j_get_args(_argv(root, names))
    args['abs_fd_exp'] = jdir
    os.makedirs(jdir)
    jexp = JExperiment(args)
    jexp.train_valid()
    with open(os.path.join(jdir, 'config_model.yml'), 'w') as f:
        yaml.safe_dump(args, f)
    params = jax.tree.map(np.asarray,
                          JCKPT.load_best(jdir, jexp.state.params))

    tdir = str(base / 'port' / 'exp')
    targs = TPARSE.get_args(_argv(root, names) + ['--device', 'cpu'])
    targs['abs_fd_exp'] = tdir
    os.makedirs(os.path.join(tdir, 'best-models'))
    texp = TExperiment(targs)
    assert targs['netG']['vdsr_upscale'] == 1
    assert texp.pipe_cfg.scale == 1 and texp.pipe_cfg.h_size == 16
    torch.save(flax_to_torch(params, texp.model),
               os.path.join(tdir, 'best-models', 'G-model.pt'))
    yaml_io.dump(targs, os.path.join(tdir, 'config_model.yml'))
    return jdir, tdir, names[2]


def _same_rows(got, want, tol=ROW_TOL):
    """fast_eval perf dicts per dataset: the same datasets, PSNR / SSIM
    (full and, where present, ROI) within tol of max(1, |value|): an f32
    PSNR resolves the identical-image cap, 496.6655 dB, to 3e-5 only
    (the ROI rows average it over the thresholds)."""
    assert sorted(got) == sorted(want)
    for ds in want:
        for scope in ('full', 'roi'):
            if scope not in want[ds]:
                continue
            for m in METRICS:
                assert abs(got[ds][scope][m] - want[ds][scope][m]) <= \
                    tol * max(1.0, abs(want[ds][scope][m])), \
                    (ds, scope, m, got[ds][scope][m], want[ds][scope][m])


def test_reevaluate_reconstruct_matches_jax(exps):
    from srcaco2_tpu.inference import reconstruct as JIR
    from srcaco2_tpu_torch.inference import reconstruct as TIR
    jdir, tdir, test = exps
    floor = f'{test}_bicubic'
    jf = JIR.reevaluate_reconstruct(jdir, 'fake')
    tf = TIR.reevaluate_reconstruct(tdir, 'fake', device='cpu')
    _same_rows(tf, jf)
    assert sorted(tf) == [test, floor] and tf[test]['n'] == 3
    img_dir = os.path.join(tdir, 'inference_reconstruct', 'images', 'fake',
                           'test', test)
    assert len([f for f in os.listdir(img_dir) if f.endswith('.png')]) == 3
    jr = JIR.reevaluate_reconstruct(jdir, 'real', n=1)
    tr = TIR.reevaluate_reconstruct(tdir, 'real', n=1, device='cpu')
    _same_rows(tr, jr)
    assert tr[floor]['n'] == 1 and tr[floor]['full']['mse'] == 0.0
    assert os.path.isdir(os.path.join(tdir, 'inference_reconstruct',
                                      'images', 'real'))
    # a super-resolution experiment is refused
    cfg = yaml_io.load(os.path.join(tdir, 'config_model.yml'))
    other = os.path.join(os.path.dirname(os.path.dirname(tdir)), 'sr')
    os.makedirs(os.path.join(other, 'best-models'))
    yaml_io.dump({**cfg, 'task': JC.SUPER_RES},
                 os.path.join(other, 'config_model.yml'))
    torch.save(torch.load(os.path.join(tdir, 'best-models', 'G-model.pt')),
               os.path.join(other, 'best-models', 'G-model.pt'))
    with pytest.raises(ValueError, match='task'):
        TIR.reevaluate_reconstruct(other, device='cpu')


@pytest.mark.parametrize('sigma', [0.0, 20.0])
def test_reevaluate_with_noise_matches_jax(exps, sigma):
    from srcaco2_tpu.inference import super_res as JSR
    from srcaco2_tpu_torch.inference import super_res as TSR
    jdir, tdir, _ = exps
    _same_rows(TSR.reevaluate(tdir, n=2, noise_sigma=sigma, device='cpu'),
               JSR.reevaluate(jdir, n=2, noise_sigma=sigma))


def test_noise_study_matches_jax(exps):
    from srcaco2_tpu.inference import super_res as JSR
    from srcaco2_tpu_torch.inference import super_res as TSR
    jdir, tdir, test = exps
    j = JSR.noise_study(jdir, sigmas=(0, 40), n=2)
    t = TSR.noise_study(tdir, sigmas=(0, 40), n=2, device='cpu')
    assert sorted(t) == sorted(j) == [0, 40]
    for s in j:
        _same_rows(t[s], j[s])
    assert t[40][test]['full']['psnr'] != t[0][test]['full']['psnr']


def test_eval_all_matches_jax(exps, tmp_path):
    """The port's sweep over a tree of the port's experiment: one 'ok'
    row whose summary equals JAX's evaluate_pretrained (what JAX's
    eval_all.py stores) on the JAX experiment; a rerun keeps it without
    re-scoring; a broken experiment gets an error row."""
    import eval as j_eval       # the JAX package's eval.py (repo root)
    from srcaco2_tpu_torch import eval_all as TEA
    jdir, tdir, test = exps
    want = j_eval.evaluate_pretrained(jdir)
    out = str(tmp_path / 'sweep.json')
    tree = os.path.dirname(tdir)
    TEA.main(['--exps_root', tree, '--out', out, '--device', 'cpu',
              '--methods', 'VDSR', '--scales', '2', '--cells', 'CELL0'])
    with open(out) as f:
        rows = json.load(f)
    assert list(rows) == [tdir]
    row = rows[tdir]
    assert {k: row[k] for k in ('net', 'scale', 'cell', 'status')} == \
        {'net': 'VDSR', 'scale': 2, 'cell': 'CELL0', 'status': 'ok'}
    assert sorted(row['datasets']) == sorted(want) == sorted(
        [test, f'{test}_bicubic'])
    for ds, w in want.items():
        for m in ('psnr', 'ssim', 'roi_psnr', 'roi_ssim'):
            assert abs(row['datasets'][ds][m] - w[m]) <= \
                ROW_TOL * max(1.0, abs(w[m])), (ds, m)
    # the filters keep the sweep from this experiment; a rerun skips the
    # 'ok' row; a directory without weights gets an error row
    assert TEA.sweep(tree, str(tmp_path / 'none.json'), methods=['SwinIR'],
                     device='cpu') == {}
    broken = os.path.join(tree, 'broken')
    os.makedirs(broken)
    yaml_io.dump(yaml_io.load(os.path.join(tdir, 'config_model.yml')),
                 os.path.join(broken, 'config_model.yml'))
    again = TEA.sweep(tree, out, device='cpu')
    assert again[tdir] == row
    assert again[broken]['status'].startswith('error')


def test_main_and_eval_run_reconstruct_on_the_cpu(synth, tmp_path,
                                                   monkeypatch):
    """The entry points on the CPU: main writes a scale-1 experiment
    whose config_model.yml rebuilds the scale-1 net, and eval re-scores
    its test rows, the identity floor included."""
    from srcaco2_tpu_torch import eval as t_eval, main as t_main
    from srcaco2_tpu_torch.utils import tracker as T
    root, names = synth
    monkeypatch.chdir(tmp_path)
    t_main.main(_argv(root, names) + ['--device', 'cpu'])
    exp = [d for d, _, f in os.walk(tmp_path / 'exps') if 'passed.txt' in f]
    assert len(exp) == 1
    exp = exp[0]
    assert '/reconstruct/VDSR/' in exp
    cfg = yaml_io.load(os.path.join(exp, 'config_model.yml'))
    assert cfg['task'] == 'reconstruct' and cfg['netG']['vdsr_upscale'] == 1
    summary = t_eval.evaluate_pretrained(exp, device='cpu')
    tracker = T.find_last_tracker(exp)
    floor = f'{names[2]}_bicubic'
    for ds in (names[2], floor):
        for m in METRICS:
            assert abs(summary[ds][m] -
                       tracker['test'][ds][m]['vals'][-1]) <= 1e-6, (ds, m)
    # the floor is the blurred input against its target
    ds = TD.load_dataset({**cfg, 'device': 'cpu'}, names[2], 'eval')
    e = ds.lr.astype(np.float64)[:, 2:-2, 2:-2]
    h = ds.hr.astype(np.float64)[:, 2:-2, 2:-2]
    mse = ((e - h) ** 2).reshape(len(ds), -1).mean(1)
    assert abs(summary[floor]['psnr'] -
               (20 * np.log10(255.0 / np.sqrt(mse))).mean()) <= 1e-4


def test_swinir_reconstruct_builds_the_scale1_net(synth, tmp_path):
    """The flagship's net at upscale 1: the port's Experiment sets
    swinir_upscale = 1, trains on h_size // scale patches, and the net
    keeps the input's size (reflect padding to the window, the crop at
    h * 1)."""
    root, names = synth
    args = TPARSE.get_args(_argv(root, names, 'SwinIR') + [
        '--device', 'cpu', '--swinir_embed_dim', '16', '--swinir_depths',
        '[2]', '--swinir_num_heads', '[2]', '--swinir_window_size', '8',
        '--swinir_upsampler', 'pixelshuffledirect'])
    args['abs_fd_exp'] = str(tmp_path)
    exp = TExperiment(args)
    assert args['netG']['swinir_upscale'] == 1
    assert (exp.pipe_cfg.scale, exp.pipe_cfg.h_size) == (1, 16)
    x = torch.rand(2, 1, 20, 28)
    with torch.no_grad():
        assert exp.model.eval()(x).shape == x.shape
    lr = exp.valid_sets[0].lr_dev
    batch = TP.make_eval_batch(exp.valid_sets[0].hr_dev, lr,
                               torch.arange(2))
    assert torch.equal(exp.interp_forward(None, batch),
                       lr[:2].permute(0, 3, 1, 2).float())


# ------------------------------------------------------ restore_grid

def _titles_of(fn, monkeypatch):
    """The axes titles restore_grid sets."""
    import matplotlib.axes
    got = []
    orig = matplotlib.axes.Axes.set_title

    def record(self, label, *a, **k):
        got.append(label)
        return orig(self, label, *a, **k)
    monkeypatch.setattr(matplotlib.axes.Axes, 'set_title', record)
    fn()
    monkeypatch.setattr(matplotlib.axes.Axes, 'set_title', orig)
    return got


def test_restore_grid_captions_match_jax(tmp_path, monkeypatch):
    """The captions: PSNR / SSIM where a panel has the HR's shape and is
    not titled HR, the title alone elsewhere; with a GIF (same-shape
    panels, as the GIF stacks them) and without one."""
    from srcaco2_tpu.diagnosis import visualize as JV
    from srcaco2_tpu_torch.diagnosis import visualize as TV
    r = np.random.default_rng(0)
    hr = r.integers(0, 256, (40, 40)).astype(np.float32)
    panels = [np.clip(hr + r.normal(0, 9, hr.shape), 0, 255).round(),
              np.clip(hr * 0.9, 0, 255).round(), hr]
    titles = ['Bicubic', 'SwinIR', 'HR']
    for case, ps, gif in (('gif', panels, True),
                          ('lr', [hr[:20, :20]] + panels[:2], False)):
        ts = ['LR'] + titles[:2] if case == 'lr' else titles
        got = {}
        for side, V in (('j', JV), ('t', TV)):
            got[side] = _titles_of(lambda: V.restore_grid(
                ps, ts, hr, str(tmp_path / f'{side}{case}.png'),
                gif_path=str(tmp_path / f'{side}{case}.gif') if gif
                else None), monkeypatch)
        assert got['t'] == got['j'] and len(got['t']) == 4
        assert got['t'][:3] == TV.restore_captions(ps, ts, hr)
        assert os.path.getsize(tmp_path / f't{case}.png') > 1_000
    assert [c.split('\n')[0] for c in got['t']] == ['LR', 'Bicubic',
                                                    'SwinIR', 'HR']
    assert 'PSNR' in got['t'][1] and 'PSNR' not in got['t'][0]
    assert os.path.getsize(tmp_path / 'tgif.gif') > 100


def test_restore_grid_names_a_missing_matplotlib(tmp_path, monkeypatch):
    from srcaco2_tpu_torch.diagnosis import visualize as TV
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    hr = np.zeros((16, 16), np.float32)
    with pytest.raises(ImportError, match='matplotlib'):
        TV.restore_grid([hr], ['x'], hr, str(tmp_path / 'x.png'))
    assert not (tmp_path / 'x.png').exists()
    # the captions need no matplotlib
    assert TV.restore_captions([hr + 1], ['x'], hr)[0].startswith('x\nPSNR')
