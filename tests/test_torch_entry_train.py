"""The port's trainer and entry points: the windowed path in training
mode at T > 256 against JAX's (loss within 1e-5, grads within 1e-4), the
superstep (K = 4 equals four K = 1 steps bit for bit), resume (a run
resumed from its checkpoint equals the uninterrupted run bit for bit),
checkpoints (save, load, GC and best, in the JAX package's layout), and
`python -m srcaco2_tpu_torch.main` / `.eval` end to end on the CPU on a
tiny SwinIR, also with PyYAML, cv2 and matplotlib made unimportable, as
on the card machine."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from srcaco2_tpu import constants as JC
from srcaco2_tpu.config.defaults import get_config as j_get_config
from srcaco2_tpu.losses.master import build_loss as j_build_loss
from srcaco2_tpu.models.swinir import SwinIR as JSwinIR
from srcaco2_tpu.train import checkpoint as JCKPT
from srcaco2_tpu.train import schedule as JS
from srcaco2_tpu.train.state import TrainState as JTrainState
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as t_get_config
from srcaco2_tpu_torch.config.parser import get_args
from srcaco2_tpu_torch.data import pipeline as TP
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.losses.master import build_loss as t_build_loss
from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
from srcaco2_tpu_torch.models.swinir import SwinIR as TSwinIR
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train import schedule as TS
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import loss_and_grads, make_train_step
from srcaco2_tpu_torch.train.trainer import Experiment
from srcaco2_tpu_torch.utils import reproducibility as R

ROOT = Path(__file__).resolve().parents[1]
NET = dict(upscale=2, window_size=4, embed_dim=16, depths=(2, 2),
           num_heads=(2, 2), upsampler='pixelshuffle', in_chans=1,
           mlp_ratio=2.0)
TINY_FLAGS = ['--swinir_embed_dim', '16', '--swinir_depths', '[2, 2]',
              '--swinir_num_heads', '[2, 2]', '--swinir_window_size', '4']


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


def _flags():
    flags = dict(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=7,
                 scale=2, h_size=48, n_channels=1)
    return {**j_get_config(JC.SWINIR), **flags}, {**t_get_config(), **flags}


def _grads_close(name, got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= 1e-4 * np.abs(ref).max() + 1e-6, (name, err)


def test_windowed_training_matches_jax():
    """SwinIR in training mode on 24x24 LR patches (T = 576 > 256: the
    windowed path on both sides), l2 + 5 neg-SSIM: the loss and the grad
    of every parameter."""
    jm = JSwinIR(fused_blocks=True, fused_mode='interpret', **NET)
    pn = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 1, 8, 8)), train=False)['params'])(
        jax.random.key(0)))
    tm = TSwinIR(device='cpu', **NET)
    tm.load_state_dict(flax_to_torch(pn, tm))
    ja, ta = _flags()
    r = np.random.default_rng(3)
    x = r.uniform(0, 1, (2, 1, 24, 24)).astype(np.float32)
    y = r.uniform(0, 1, (2, 1, 48, 48)).astype(np.float32)
    jmaster = j_build_loss(ja)

    def jloss(pp):
        out = jm.apply({'params': pp}, jnp.asarray(x), train=True)
        return jmaster(out, {'h_im': jnp.asarray(y)})[0]
    lj, gj = jax.jit(jax.value_and_grad(jloss))(pn)
    calls = []
    stacks = [m for m in tm.modules() if isinstance(m, FusedBlockStack)]
    for m in stacks:
        m.fused_op = m.block_op = lambda *a, **k: calls.append(1)
    params = dict(tm.named_parameters())
    lt, _, _, gt = loss_and_grads(
        tm, t_build_loss(ta), 'SwinIR', params,
        {'l_im': torch.from_numpy(x), 'h_im': torch.from_numpy(y)}, 0, 1.0)
    assert not calls                  # neither the fused nor the tiled path
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gj_t = flax_to_torch(jax.tree.map(np.asarray, gj), tm)
    assert set(gj_t) == set(gt)
    for k in gt:
        _grads_close(k, gt[k], gj_t[k])


@pytest.mark.parametrize('train,hw', [(True, (24, 24)), (True, (32, 32)),
                                      (False, (24, 40))])
def test_windowed_path_takes_any_device(train, hw):
    """Off the CPU (a meta tensor: no card is needed to reach the
    dispatch) the shapes that neither kernel path takes run the windowed
    path, with its index and mask built on that device, instead of
    raising; ws 8 gives 2ws = 16, so 24 is not a tile multiple and
    training never takes the tiled path."""
    m = FusedBlockStack(32, 2, 2, 8, 2.0, device='meta').train(train)
    x = torch.empty(2, *hw, 32, device='meta')
    y = m(x)
    assert y.shape == x.shape and y.device.type == 'meta'
    rel, mask = m._win_plans[(*hw, 'meta')]
    assert rel.device.type == mask.device.type == 'meta'


def _tiny_model(seed=0):
    tm = TSwinIR(device='cpu', **NET)
    tm.reset_parameters(torch.Generator().manual_seed(seed))
    return tm


def _run_steps(ks, n_steps=4, bs=3):
    """A fresh tiny model trained n_steps steps on a fixed stack, in
    calls of k steps for k in `ks`; the draws of step s come from
    step_generator(7, s). Returns (state, holders)."""
    tm = _tiny_model()
    _, ta = _flags()
    ta['h_size'] = 16
    tx = TS.build_optimizer(ta['train'])
    cfg = TP.PipeConfig(scale=2, h_size=16)
    r = np.random.default_rng(0)
    hr = torch.from_numpy(r.integers(0, 256, (5, 32, 32, 1), np.uint8))
    lr = torch.from_numpy(r.integers(0, 256, (5, 16, 16, 1), np.uint8))
    state = TrainState.create(dict(tm.named_parameters()), tx, e_decay=0.9)
    master = t_build_loss(ta)
    holders, step = [], 0
    for k in ks:
        fn = make_train_step(tm, master, tx, 'SwinIR', cfg, e_decay=0.9,
                             steps_per_epoch=2, steps_per_call=k)
        idxs = torch.from_numpy(r.integers(0, 5, (k, bs)))
        draws = [TP.draw(R.step_generator(7, step + j, 'cpu'), bs, cfg,
                         (32, 32)) for j in range(k)]
        if k > 1:
            state, h, ok = fn(state, hr, lr, idxs, draws)
        else:
            state, h, ok = fn(state, hr, lr, idxs[0], draws[0])
            h = {n: v[None] for n, v in h.items()}
        assert bool(ok)
        holders.append(h)
        step += k
    assert step == n_steps
    return state, {n: torch.cat([h[n] for h in holders]) for n in holders[0]}


def test_superstep_equals_single_steps():
    s4, h4 = _run_steps([4])
    s1, h1 = _run_steps([1, 1, 1, 1])
    s22, _ = _run_steps([2, 2])
    assert int(s4.step) == int(s1.step) == 4
    for st in (s1, s22):
        for k in s4.params:
            assert torch.equal(s4.params[k], st.params[k]), k
            assert torch.equal(s4.ema_params[k], st.ema_params[k]), k
            assert torch.equal(s4.opt_state['adam']['nu'][k],
                               st.opt_state['adam']['nu'][k]), k
    assert h4.keys() == h1.keys() and h4['total'].shape == (4,)
    for n in h4:
        assert torch.equal(h4[n], h1[n]), n


def _tiny_args(root, names, exp, epochs, **extra):
    argv = ['--device', 'cpu', '--scale', '2', '--h_size', '16',
            '--n_channels', '1', '--train_dsets', names[0],
            '--valid_dsets', names[1], '--test_dsets', names[2],
            '--data_root', root, '--splits_root', root, '--l2', 'True',
            '--ssim', 'True', '--ssim_lambda', '5.', '--ssim_window_s', '7',
            '--eval_over_roi_also', 'True', '--batch_size', '2',
            '--eval_bsize', '2', '--max_epochs', str(epochs),
            '--checkpoint_eval', '1.0', '--checkpoint_save', '1.0',
            '--E_decay', '0.9', '--train_steps_per_call', '3',
            '--plot_epoch_freq', '0', '--verbose', 'False', *TINY_FLAGS]
    for k, v in extra.items():
        argv += [f'--{k}', str(v)]
    args = get_args(argv)
    args['abs_fd_exp'] = exp
    os.makedirs(exp, exist_ok=True)
    return args


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('synth'))
    names = make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=8,
                                   n_val=2, n_test=2, size=64)
    return root, names


def test_resume_equals_uninterrupted_run(synth, tmp_path, monkeypatch):
    """4 steps per epoch in chunks of up to 3 (3 + 1): two epochs in one
    run, against one epoch, then a new Experiment resumed from its
    checkpoint for the second."""
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')   # skip the final tests
    root, names = synth
    full = Experiment(_tiny_args(root, names, str(tmp_path / 'a'), 2))
    full.train_valid()
    part = str(tmp_path / 'b')
    Experiment(_tiny_args(root, names, part, 1)).train_valid()
    assert CKPT.find_last_checkpoint(part) == 4
    resumed = Experiment(_tiny_args(root, names, part, 2))
    resumed.train_valid()
    assert int(full.state.step) == int(resumed.state.step) == 8
    for k, p in full.state.params.items():
        assert torch.equal(p, resumed.state.params[k]), k
        assert torch.equal(full.state.ema_params[k],
                           resumed.state.ema_params[k]), k
    assert float(full.state.elb_t) == float(resumed.state.elb_t)
    assert full.stats['train_steps'] == 8
    assert resumed.stats['train_steps'] == 4
    assert full.stats['model_forwards']['val'] == 3


def _jax_layout(tmp_path):
    """The files JAX's checkpoint module writes for steps 3 and 5 (GC to
    5) and a multi-valid best model."""
    d = str(tmp_path / 'jax')
    p = {'w': jnp.ones((2, 3)), 'b': jnp.zeros((3,))}
    st = JTrainState.create(p, JS.build_optimizer(
        j_get_config(JC.SWINIR)['train']), e_decay=0.9)
    for step in (3, 5):
        JCKPT.save_checkpoint(d, st.replace(step=jnp.int32(step)))
    JCKPT.gc_checkpoints(d, 5)
    JCKPT.save_best(d, p)
    JCKPT.save_best(d, p, 'ds_val')
    return {k: sorted(os.listdir(os.path.join(d, k)))
            for k in ('models', 'best-models')}


def test_checkpoint_round_trips_in_jax_layout(tmp_path):
    tm = _tiny_model()
    _, ta = _flags()
    tx = TS.build_optimizer(ta['train'])
    st = TrainState.create(dict(tm.named_parameters()), tx, e_decay=0.9)
    d = str(tmp_path / 'port')
    for step in (3, 5):
        st.step = torch.tensor(step, dtype=torch.int32)
        with torch.no_grad():
            for p in st.params.values():
                p.add_(1.0)
        st.elb_t = torch.tensor(1.5 * step)
        CKPT.save_checkpoint(d, st)
    saved = {k: v.detach().clone() for k, v in st.params.items()}
    CKPT.gc_checkpoints(d, 5)
    CKPT.save_best(d, st.params)
    CKPT.save_best(d, st.params, 'ds_val')
    layout = {k: sorted(f[:-3] for f in os.listdir(os.path.join(d, k)))
              for k in ('models', 'best-models')}
    assert layout == _jax_layout(tmp_path)
    assert CKPT.find_last_checkpoint(d) == 5

    fresh = TrainState.create(dict(_tiny_model(1).named_parameters()), tx,
                              e_decay=0.9)
    fresh, step = CKPT.load_checkpoint(d, fresh)
    assert step == 5 and int(fresh.step) == 5 and float(fresh.elb_t) == 7.5
    for k, v in saved.items():
        assert torch.equal(fresh.params[k], v), k
    assert torch.equal(fresh.opt_state['adam']['count'],
                       st.opt_state['adam']['count'])
    best = CKPT.load_best(d, 'cpu')
    assert best.keys() == saved.keys()
    assert all(torch.equal(best[k], v) for k, v in saved.items())
    # a validation set without its own file falls back to G-model.pt
    assert torch.equal(CKPT.load_best(d, 'cpu', 'other')['conv_first.weight'],
                       saved['conv_first.weight'])
    path = os.path.join(d, 'best-models', 'G-model.pt')
    assert all(torch.equal(v, saved[k]) for k, v in CKPT.load_params(
        path, dict(_tiny_model(2).named_parameters())).items())
    other = TSwinIR(device='cpu', **{**NET, 'depths': (2,),
                                     'num_heads': (2,)})
    merged = CKPT.load_params_nonstrict(path, dict(other.named_parameters()))
    assert torch.equal(merged['conv_first.weight'],
                       saved['conv_first.weight'])
    with pytest.raises(KeyError):
        CKPT.load_params(path, dict(other.named_parameters()))


def _run(args, cwd, code=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    cmd = [sys.executable] + (['-c', code] if code else ['-m']) + args
    res = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res


def _check_experiment(exp, names, test_summary=None):
    with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
        tracker = pickle.load(f)
    assert CKPT.find_last_checkpoint(exp) == 8   # 8 samples / 2 x 2 epochs
    assert os.path.isfile(os.path.join(exp, 'best-models', 'G-model.pt'))
    assert os.path.isfile(os.path.join(exp, 'passed.txt'))
    for f in ('config.yml', 'config_final.yml', 'config_model.yml',
              'cmd.sh', 'log.txt', 'log.json', 'LOG.txt', 'run_stats.json',
              'roi_tracker.pkl'):
        assert os.path.isfile(os.path.join(exp, f)), f
    vals = tracker[JC.VALIDSET][names[1]][JC.PSNR_MTR]
    assert len(vals['vals']) == 3 and vals['best_val'] is not None
    l2 = tracker['train']['period_epoch']['l2']
    assert len(l2) == 2 and all(np.isfinite(v) for v in l2)
    assert len(tracker['train']['period_iter']['total']) == 8
    for ds in (names[2], names[2] + '_bicubic'):
        assert tracker[JC.TESTSET][ds][JC.PSNR_MTR]['vals'], ds
    return tracker


def test_main_and_eval_end_to_end(synth, tmp_path):
    root, names = synth
    argv = ['srcaco2_tpu_torch.main', '--device', 'cpu', '--scale', '2',
            '--h_size', '16', '--n_channels', '1', '--train_dsets', names[0],
            '--valid_dsets', names[1], '--test_dsets', names[2],
            '--data_root', root, '--splits_root', root, '--l2', 'True',
            '--ssim', 'True', '--ssim_lambda', '5.', '--ssim_window_s', '7',
            '--eval_over_roi_also', 'True',
            '--eval_over_roi_also_model_select', 'True',
            '--batch_size', '2', '--eval_bsize', '2', '--max_epochs', '2',
            '--checkpoint_eval', '1.0', '--checkpoint_save', '1.0',
            *TINY_FLAGS]
    _run(argv, str(tmp_path))
    exp = str(next(tmp_path.glob('exps/**/passed.txt')).parent)
    tracker = _check_experiment(exp, names)
    # a second start finds passed.txt and exits at once
    again = _run(argv, str(tmp_path))
    assert 'already completed' in again.stdout
    _run(['srcaco2_tpu_torch.eval', '--exp_path', exp, '--device', 'cpu'],
         str(tmp_path))
    with open(os.path.join(exp, 'eval_test_test', 'tracker.pkl'), 'rb') as f:
        ev = pickle.load(f)
    for m in (JC.PSNR_MTR, JC.SSIM_MTR):
        for ds in (names[2], names[2] + '_bicubic'):
            assert abs(ev[JC.TESTSET][ds][m]['vals'][-1]
                       - tracker[JC.TESTSET][ds][m]['vals'][-1]) <= 1e-6


CARD_LIKE = '''
import sys
for m in ("yaml", "cv2", "matplotlib"):
    sys.modules[m] = None
import glob, os, numpy as np, torch
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch import main, eval as ev
from srcaco2_tpu_torch.inference.super_res import load_exp
from srcaco2_tpu_torch.config import yaml_io
assert yaml_io.yaml is None
names = make_synthetic_dataset("data", scale=2, n_train=4, n_val=2,
                               n_test=2, size=32)
main.main(["--device", "cpu", "--scale", "2", "--h_size", "16",
           "--n_channels", "1", "--train_dsets", names[0],
           "--valid_dsets", names[1], "--test_dsets", names[2],
           "--data_root", "data", "--l2", "True", "--batch_size", "2",
           "--eval_bsize", "2", "--max_epochs", "1",
           "--checkpoint_eval", "1.0", "--checkpoint_save", "1.0",
           "--swinir_embed_dim", "16", "--swinir_depths", "[2, 2]",
           "--swinir_num_heads", "[2, 2]", "--swinir_window_size", "4"])
exp = os.path.dirname(glob.glob("exps/**/passed.txt", recursive=True)[0])
ev.main(["--exp_path", exp, "--device", "cpu"])
model, args = load_exp(exp, "cpu")
assert args["netG"]["swinir_depths"] == [2, 2]
assert args["train"]["G_optimizer_lr"] == 2e-4
state = torch.load(os.path.join(exp, "best-models", "G-model.pt"),
                   weights_only=True)
assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
out = model(torch.zeros(1, 1, 16, 16))
assert out.shape == (1, 1, 32, 32) and torch.isfinite(out).all()
print("card-like ok")
'''


def test_entry_points_without_yaml_cv2_or_matplotlib(tmp_path):
    """The card machine has no PyYAML, cv2 or matplotlib: the synthetic
    dataset (uncompressed TIFF), main, eval and load_exp run without
    them, on the experiment the port's trainer writes."""
    res = _run([], str(tmp_path), code=CARD_LIKE)
    assert 'card-like ok' in res.stdout
    exp = next(tmp_path.glob('exps/**/passed.txt')).parent
    import yaml
    with open(exp / 'config_model.yml') as f:
        cfg = yaml.safe_load(f)
    assert cfg['netG']['swinir_depths'] == [2, 2]
    assert cfg['device'] == 'cpu'


def test_caches_built_under_inference_mode_serve_training():
    """An eval forward (under inference_mode) first, then a training
    step on the same shapes: the cached index, mask and bias tensors
    built by the eval forward must be normal tensors that autograd can
    save (the fused path at 12x20 LR, the windowed one at 24x28)."""
    for hw in ((12, 20), (24, 28)):
        tm = _tiny_model()
        x = torch.rand(1, 1, *hw)
        with torch.inference_mode():
            tm.eval()(x)
        out = tm.train()(x)
        out.sum().backward()
        assert tm.conv_first.weight.grad is not None
