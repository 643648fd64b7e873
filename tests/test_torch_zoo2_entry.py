"""NLSN, GRL, DRRN and MemNet through the port's entry points on the CPU:
`main` then `eval` (in this process, --device cpu) at small widths, 1
epoch of 2 steps with a validation and the test; the re-scored test
equals the trainer's final test within 1e-6. MemNet's BatchNorm
statistics travel with the checkpoints: they moved in training, the
step checkpoint and the best model carry the trained values, and a
fresh model restored from them (load_checkpoint, load_exp) holds them.
SRServer serves MemNet (its evaluation normalises with the running
statistics) against the JAX module's apply on the same variables."""
import glob
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from srcaco2_tpu.config.net_defaults import init_net_g as j_init_net_g
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu_torch import constants as TC
from srcaco2_tpu_torch import eval as t_eval
from srcaco2_tpu_torch import main as t_main
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.inference.serve import SRServer as TSRServer
from srcaco2_tpu_torch.inference.super_res import load_exp
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train.schedule import build_optimizer
from srcaco2_tpu_torch.train.state import TrainState

from test_torch_zoo2 import _random_stats


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """4 / 2 / 2 images of 128^2 at x2 (an untrained net's SSIM on a
    64^2 image can come out below 0, which fast_eval stops on)."""
    root = str(tmp_path_factory.mktemp('zoo2_x2'))
    return root, make_synthetic_dataset(root, scale=2, cell='CELL0',
                                        n_train=4, n_val=2, n_test=2,
                                        size=128)


RUNS = {
    'DRRN': ['--drrn_num_residual_units', '2'],
    'MemNet': ['--memnet_num_memory_blocks', '2',
               '--memnet_num_residual_blocks', '2'],
    'NLSN': ['--nlsn_n_resblocks', '8', '--nlsn_n_feats', '16',
             '--nlsn_chunk_size', '16'],
    'GRL': ['--grl_embed_dim', '16', '--grl_depths', '[2]',
            '--grl_num_heads_window', '[2]', '--grl_num_heads_stripe', '[2]',
            '--grl_window_size', '4'],
}


@pytest.mark.parametrize('nt', sorted(RUNS))
def test_main_and_eval_end_to_end(nt, dataset, tmp_path, monkeypatch):
    root, names = dataset
    monkeypatch.chdir(tmp_path)
    t_main.main(['--device', 'cpu', '--net_type', nt, '--scale', '2',
                 '--h_size', '16', '--n_channels', '1',
                 '--train_dsets', names[0], '--valid_dsets', names[1],
                 '--test_dsets', names[2], '--data_root', root,
                 '--splits_root', root, '--l2', 'True', '--ssim', 'True',
                 '--ssim_lambda', '5.', '--ssim_window_s', '7',
                 '--batch_size', '2', '--eval_bsize', '2',
                 '--max_epochs', '1', '--checkpoint_eval', '1.0',
                 '--checkpoint_save', '1.0', *RUNS[nt]])
    exp = os.path.dirname(glob.glob('exps/**/passed.txt', recursive=True)[0])
    assert CKPT.find_last_checkpoint(exp) == 2
    with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
        tracker = pickle.load(f)
    assert len(tracker['val'][names[1]]['psnr']['vals']) == 2
    assert len(tracker['train']['period_iter']['total']) == 2
    with open(os.path.join(exp, 'run_stats.json')) as f:
        launches = json.load(f)['launches']
    assert all(v == 0 for ph in launches.values() for v in ph.values())
    t_eval.main(['--exp_path', exp, '--device', 'cpu'])
    with open(os.path.join(exp, 'eval_test_test', 'tracker.pkl'), 'rb') as f:
        ev = pickle.load(f)
    for m in ('psnr', 'ssim'):
        for ds in (names[2], names[2] + '_bicubic'):
            a = tracker['test'][ds][m]['vals'][-1]
            assert abs(ev['test'][ds][m]['vals'][-1] - a) <= 1e-6, (ds, m)
    model, args = load_exp(exp, 'cpu')
    assert args['netG']['net_type'] == nt
    best = torch.load(os.path.join(exp, 'best-models', 'G-model.pt'),
                      weights_only=True)
    assert best.keys() == model.state_dict().keys()
    if nt == TC.MEMNET:
        stats = [k for k in best if k.endswith(('.mean', '.var'))]
        assert len(stats) == 2 * (2 + 2 * (1 + 2 * 2))
        step_ckpt = torch.load(os.path.join(exp, 'models', '2_G.pt'),
                               weights_only=True)
        fresh = t_define_g(args, 'cpu')
        init = fresh.state_dict()
        # two training forwards moved every statistic; the step
        # checkpoint holds them, and so does the best model (the last
        # validation's)
        assert all(not torch.equal(step_ckpt[k], init[k]) for k in stats)
        assert all(torch.equal(step_ckpt[k], best[k]) for k in stats)
        live = model.state_dict()
        assert all(torch.equal(live[k], best[k]) for k in stats)
        # resume: load_checkpoint writes them into the model's buffers
        params = dict(fresh.named_parameters())
        bufs = {k: v for k, v in fresh.state_dict(keep_vars=True).items()
                if k not in params}
        st = TrainState.create(params, build_optimizer(args['train']))
        st, step = CKPT.load_checkpoint(exp, st, buffers=bufs)
        assert step == 2
        assert all(torch.equal(dict(fresh.named_buffers())[k],
                               step_ckpt[k]) for k in stats)
    out = model(torch.zeros(1, 1, 8, 8))['out']
    assert out.shape == (1, 1, 16, 16)


LR_HW = (12, 12)


@pytest.fixture(scope='module')
def memnet_exp(tmp_path_factory):
    """A small MemNet experiment dir from JAX's init params and seeded
    random batch statistics: (exp dir, JAX variables, args)."""
    exp = tmp_path_factory.mktemp('memnet_serve')
    args = {'scale': 2, 'n_channels': 1, 'h_size': 24, 'amp': False}
    args['netG'] = j_init_net_g({'net_type': 'MemNet'}, args)
    args['netG'].update(memnet_num_memory_blocks=2,
                        memnet_num_residual_blocks=2)
    with open(exp / 'config_model.yml', 'w') as f:
        yaml.safe_dump(args, f)
    v = jax.tree.map(np.asarray, jax.jit(lambda k: j_define_g(args).init(
        k, jnp.zeros((1, 1, *LR_HW)), train=False))(jax.random.key(0)))
    v = {**v, 'batch_stats': _random_stats(v['batch_stats'])}
    os.makedirs(exp / 'best-models', exist_ok=True)
    torch.save(flax_to_torch(v['params'], t_define_g(args, 'cpu'),
                             model_state=v),
               exp / 'best-models' / 'G-model.pt')
    return str(exp), v, args


def test_memnet_server_matches_jax(memnet_exp):
    """3 requests through batches of 2 (the tail padded): the port's
    uint8 pixels against JAX's apply on the same variables (params and
    batch statistics) rounded alike; the LR batch goes in as it is
    (MemNet upscales internally)."""
    exp, v, args = memnet_exp
    x = np.random.default_rng(0).integers(0, 256, (3, 1, *LR_HW),
                                          dtype=np.uint8)
    srv = TSRServer(exp, batch_size=2, lr_hw=LR_HW, device='cpu')
    assert not srv.pre_upsampled and not srv.model.training
    out = srv(x)
    assert out.shape == (3, 1, 24, 24) and out.dtype == np.uint8
    y = jax.jit(lambda t: j_define_g(args).apply(v, t, train=False))(
        jnp.asarray(x, jnp.float32) / 255.0)['out']
    ref = np.asarray(jnp.clip(jnp.round(jnp.clip(y, 0, 1) * 255.0), 0,
                              255)).astype(np.uint8)
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    np.testing.assert_array_equal(srv(x[2:]), out[2:])
    # the server normalises with the running statistics, not the batch's
    srv.model.train()
    moved = srv(x[:2])
    assert not np.array_equal(moved, out[:2])
