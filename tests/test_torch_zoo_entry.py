"""The zoo through the port's entry points on the CPU: `main` then `eval`
(in this process, --device cpu) for DFCAN (x2), MSLapSRN (x4: the
progressive loss over one intermediate level) and a tiny ENLCN (its
projection buffers in the checkpoints), each 1 epoch of 2 steps with a
validation and the test; the re-scored test equals the trainer's final
test within 1e-6. SRServer serves SRCNN (the bicubic pre-upscale of the
LR batch) on the CPU against the JAX SRServer on the same weights."""
import glob
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from srcaco2_tpu.config.net_defaults import init_net_g as j_init_net_g
from srcaco2_tpu.inference.serve import SRServer as JSRServer
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu.train import checkpoint as JCKPT
from srcaco2_tpu_torch import constants as TC
from srcaco2_tpu_torch import eval as t_eval
from srcaco2_tpu_torch import main as t_main
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.inference.serve import SRServer as TSRServer
from srcaco2_tpu_torch.inference.super_res import load_exp
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import checkpoint as CKPT


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    """{scale: (root, names)}: 4 / 2 / 2 images of 128^2 per scale. A
    net at its initial weights has an SSIM near 0 on each image; at
    64^2 a window average can come out below 0, which fast_eval stops on
    as corruption (as the JAX package does)."""
    out = {}
    for scale in (2, 4):
        root = str(tmp_path_factory.mktemp(f'zoo_x{scale}'))
        out[scale] = root, make_synthetic_dataset(
            root, scale=scale, cell='CELL0', n_train=4, n_val=2, n_test=2,
            size=128)
    return out


RUNS = {
    'DFCAN': (2, []),
    'MSLapSRN': (4, []),
    'ENLCN': (2, ['--enlcn_n_feats', '16', '--enlcn_n_resblock', '8']),
}


@pytest.mark.parametrize('nt', sorted(RUNS))
def test_main_and_eval_end_to_end(nt, datasets, tmp_path, monkeypatch):
    scale, extra = RUNS[nt]
    root, names = datasets[scale]
    monkeypatch.chdir(tmp_path)
    t_main.main(['--device', 'cpu', '--net_type', nt, '--scale', str(scale),
                 '--h_size', '16', '--n_channels', '1',
                 '--train_dsets', names[0], '--valid_dsets', names[1],
                 '--test_dsets', names[2], '--data_root', root,
                 '--splits_root', root, '--l2', 'True', '--ssim', 'True',
                 '--ssim_lambda', '5.', '--ssim_window_s', '7',
                 '--batch_size', '2', '--eval_bsize', '2',
                 '--max_epochs', '1', '--checkpoint_eval', '1.0',
                 '--checkpoint_save', '1.0', *extra])
    exp = os.path.dirname(glob.glob('exps/**/passed.txt', recursive=True)[0])
    assert CKPT.find_last_checkpoint(exp) == 2      # 4 samples / 2
    best = os.path.join(exp, 'best-models', 'G-model.pt')
    with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
        tracker = pickle.load(f)
    assert len(tracker['val'][names[1]]['psnr']['vals']) == 2  # step 0, 2
    assert len(tracker['train']['period_iter']['total']) == 2
    with open(os.path.join(exp, 'run_stats.json')) as f:
        launches = __import__('json').load(f)['launches']
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
    state = torch.load(best, weights_only=True)
    assert state.keys() == model.state_dict().keys()
    if nt == TC.ENLCN:
        # the fixed projections travel with the best model and the
        # step checkpoint
        projs = [k for k in state if k.endswith('.proj')]
        assert len(projs) == 2
        step_ckpt = torch.load(os.path.join(exp, 'models', '2_G.pt'),
                               weights_only=True)
        assert all(torch.equal(step_ckpt[k], state[k]) for k in projs)
    out = model(torch.zeros(1, 1, 8, 8))['out']
    assert out.shape == (1, 1, 8 * scale, 8 * scale)


LR_HW = (12, 12)


@pytest.fixture(scope='module')
def srcnn_exp(tmp_path_factory):
    """An SRCNN experiment dir: the JAX side's orbax best model, the
    port's G-model.pt bridged from the same init params."""
    exp = tmp_path_factory.mktemp('srcnn_serve')
    args = {'scale': 2, 'n_channels': 1, 'h_size': 24, 'amp': False}
    args['netG'] = j_init_net_g({'net_type': 'SRCNN'}, args)
    with open(exp / 'config_model.yml', 'w') as f:
        yaml.safe_dump(args, f)
    params = jax.jit(lambda k: j_define_g(args).init(
        k, jnp.zeros((1, 1, 24, 24)), train=False)['params'])(
        jax.random.key(0))
    # the recon layer's 1e-3 init gives a near-constant image: scale it
    # up so the served pixels carry the input
    params['Conv_2']['kernel'] = params['Conv_2']['kernel'] * 300.0
    JCKPT.save_best(str(exp), params)
    os.makedirs(exp / 'best-models', exist_ok=True)
    torch.save(flax_to_torch(jax.tree.map(np.asarray, params),
                             t_define_g(args, 'cpu')),
               exp / 'best-models' / 'G-model.pt')
    return str(exp)


def test_srcnn_server_matches_jax(srcnn_exp):
    """3 requests through batches of 2 (the tail padded): the port's
    uint8 pixels against the JAX server's, and the pre-upscale taken."""
    x = np.random.default_rng(0).integers(0, 256, (3, 1, *LR_HW),
                                          dtype=np.uint8)
    j_out = JSRServer(srcnn_exp, batch_size=2, lr_hw=LR_HW)(x)
    srv = TSRServer(srcnn_exp, batch_size=2, lr_hw=LR_HW, device='cpu')
    assert srv.pre_upsampled
    out = srv(x)
    assert out.shape == (3, 1, 24, 24) and out.dtype == np.uint8
    assert out.std() > 5          # the served image is no constant
    diff = np.abs(out.astype(np.int16) - j_out.astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    np.testing.assert_array_equal(srv(x[2:]), out[2:])
