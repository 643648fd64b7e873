"""DBPN, ProSR, DSR-Splines, CSR-CNN and EDSR-LIIF through the port's
entry points on the CPU: `main` then `eval` (in this process, --device
cpu) at small widths, 1 epoch of 2 steps with a validation and the test;
the re-scored test equals the trainer's final test within 1e-6. ProSR
runs at x4 (its progressive loss over one intermediate level, its
level_config given on the command line with int keys). The
segmentation task of CSR-CNN is held by test_torch_zoo3_train.py's step
(ce): untrained, its argmax image can score an SSIM below 0 on these
images, which fast_eval stops on as corruption, as the JAX package's
does. The level_config keeps its int
keys through the port's YAML files with and without PyYAML. SRServer
serves CSR-CNN (the bicubic pre-upscale of the LR batch, as JAX's server
feeds every CSR-CNN but the pyramid) on the CPU against the JAX SRServer
on the same weights."""
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
from srcaco2_tpu.inference.serve import SRServer as JSRServer
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu.train import checkpoint as JCKPT
from srcaco2_tpu_torch import eval as t_eval
from srcaco2_tpu_torch import main as t_main
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
from srcaco2_tpu_torch.inference.serve import SRServer as TSRServer
from srcaco2_tpu_torch.inference.super_res import load_exp
from srcaco2_tpu_torch.models.registry import define_g as t_define_g
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train.steps import pre_upsampled


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    """{scale: (root, names)}: 4 / 2 / 2 images of 128^2 (an untrained
    net's SSIM on a 64^2 image can come out below 0, which fast_eval
    stops on)."""
    out = {}
    for scale in (2, 4):
        root = str(tmp_path_factory.mktemp(f'zoo3_x{scale}'))
        out[scale] = root, make_synthetic_dataset(
            root, scale=scale, cell='CELL0', n_train=4, n_val=2, n_test=2,
            size=128)
    return out


_LEVELS = '{2: [[2]], 4: [[2], [1]], 8: [[1], [1], [1]]}'
# net: (net_type, scale, flags)
RUNS = {
    'DBPN': ('DBPN', 2, ['--dbpn_base_filter', '8', '--dbpn_feat', '16',
                         '--dbpn_num_stages', '1']),
    'ProSR': ('ProSR', 4, ['--prosr_num_init_features', '16',
                           '--prosr_growth_rate', '8', '--prosr_bn_size',
                           '2', '--prosr_level_config', _LEVELS]),
    'DSRSplines': ('DSRSplines', 2, []),
    'CSRCNN': ('CSRCNN', 2, ['--csrcnn_inner_channel', '8',
                             '--csrcnn_res_blocks', '1']),
    'EDSR_LIIF': ('EDSR_LIIF', 2, ['--edsr_liif_n_feats', '8',
                                   '--edsr_liif_n_resblocks', '2']),
}


@pytest.mark.parametrize('run', sorted(RUNS))
def test_main_and_eval_end_to_end(run, datasets, tmp_path, monkeypatch):
    nt, scale, extra = RUNS[run]
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
    assert CKPT.find_last_checkpoint(exp) == 2
    with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
        tracker = pickle.load(f)
    assert len(tracker['val'][names[1]]['psnr']['vals']) == 2
    terms = tracker['train']['period_iter']
    assert len(terms['total']) == 2
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
    if run == 'ProSR':
        assert args['netG']['prosr_level_config'] == yaml.safe_load(_LEVELS)
        assert len(model.cfg) == 2
    hw = 8 * scale if pre_upsampled(nt, args['netG']) else 8
    out = model(torch.zeros(1, 1, hw, hw))['out']
    assert out.shape == (1, 1, 8 * scale, 8 * scale)


def test_level_config_keeps_int_keys_without_pyyaml(tmp_path, monkeypatch):
    """ProSR's level_config, keyed by scale, written to a config file and
    read back equal, with PyYAML and in the JSON form without it."""
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = {'scale': 8, 'n_channels': 1, 'h_size': 64}
    netG = init_net_g({'net_type': 'ProSR'}, args)
    cfg = netG['prosr_level_config']
    assert set(cfg) == {2, 4, 8}
    for name, mod in (('with', yaml), ('without', None)):
        monkeypatch.setattr(yaml_io, 'yaml', mod)
        path = str(tmp_path / f'config_{name}.yml')
        yaml_io.dump(netG, path)
        assert yaml_io.load(path) == netG
    assert yaml.safe_load(yaml_io.to_json(cfg)) == \
        {str(k): v for k, v in cfg.items()}


LR_HW = (12, 12)


@pytest.fixture(scope='module')
def csrcnn_exp(tmp_path_factory):
    """A small CSR-CNN (unet) experiment dir: the JAX side's orbax best
    model, the port's G-model.pt bridged from the same init params."""
    exp = tmp_path_factory.mktemp('csrcnn_serve')
    args = {'scale': 2, 'n_channels': 1, 'h_size': 24, 'amp': False}
    args['netG'] = j_init_net_g({'net_type': 'CSRCNN'}, args)
    args['netG'].update(csrcnn_inner_channel=8, csrcnn_res_blocks=1)
    with open(exp / 'config_model.yml', 'w') as f:
        yaml.safe_dump(args, f)
    params = jax.jit(lambda k: j_define_g(args).init(
        k, jnp.zeros((1, 1, 24, 24)), train=False)['params'])(
        jax.random.key(0))
    JCKPT.save_best(str(exp), params)
    os.makedirs(exp / 'best-models', exist_ok=True)
    torch.save(flax_to_torch(jax.tree.map(np.asarray, params),
                             t_define_g(args, 'cpu')),
               exp / 'best-models' / 'G-model.pt')
    return str(exp)


def test_csrcnn_server_matches_jax(csrcnn_exp):
    """3 requests through batches of 2 (the tail padded): the port's
    uint8 pixels against the JAX server's; the server takes the
    pre-upscale (rounded to the uint8 grid) for the unet, and the LR
    batch for the pyramid."""
    x = np.random.default_rng(0).integers(0, 256, (3, 1, *LR_HW),
                                          dtype=np.uint8)
    j_out = JSRServer(csrcnn_exp, batch_size=2, lr_hw=LR_HW)(x)
    srv = TSRServer(csrcnn_exp, batch_size=2, lr_hw=LR_HW, device='cpu')
    assert srv.pre_upsampled
    out = srv(x)
    assert out.shape == (3, 1, 24, 24) and out.dtype == np.uint8
    assert out.std() > 5
    diff = np.abs(out.astype(np.int16) - j_out.astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    np.testing.assert_array_equal(srv(x[2:]), out[2:])
    assert not pre_upsampled('CSRCNN', {'csrcnn_net_type': 'pyramid'})
    assert pre_upsampled('CSRCNN', {'csrcnn_net_type': 'snet_type3'})
    assert not pre_upsampled('DBPN', {})
