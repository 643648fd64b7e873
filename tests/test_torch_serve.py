"""Port SRServer (srcaco2_tpu_torch/inference/serve.py) against the JAX
SRServer on one small SwinIR experiment dir: the JAX side restores an
orbax save_best of the init params, the port a G-model.pt bridged from
the same params. Also: the port imports without jax and names nothing
of the JAX package, and its entry points want a card unless asked for
the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from srcaco2_tpu.config.net_defaults import init_net_g
from srcaco2_tpu.inference.serve import SRServer as JSRServer
from srcaco2_tpu.models.registry import define_g as j_define_g
from srcaco2_tpu.train import checkpoint as CKPT
from srcaco2_tpu_torch import resolve_device
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.inference.serve import SRServer as TSRServer
from srcaco2_tpu_torch.models.registry import define_g as t_define_g

ROOT = Path(__file__).resolve().parents[1]
LR_HW = (24, 24)     # 576 tokens, 8-pixel tileable: the tiled path


def _args():
    args = {'scale': 2, 'n_channels': 1, 'h_size': 32, 'amp': False}
    netG = init_net_g({'net_type': 'SwinIR'}, args)
    netG.update(swinir_window_size=4, swinir_embed_dim=16,
                swinir_depths=[2], swinir_num_heads=[2],
                swinir_upsampler='pixelshuffledirect')
    args['netG'] = netG
    return args


@pytest.fixture(scope='module')
def exp_dir(tmp_path_factory):
    exp = tmp_path_factory.mktemp('torch_serve')
    args = _args()
    with open(exp / 'config_model.yml', 'w') as f:
        yaml.safe_dump(args, f)
    model = j_define_g(args)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 1, 16, 16)), train=False)['params'])(
        jax.random.key(0))
    CKPT.save_best(str(exp), params)
    port = t_define_g(args, 'cpu')
    os.makedirs(exp / 'best-models', exist_ok=True)
    torch.save(flax_to_torch(jax.tree.map(np.asarray, params), port),
               exp / 'best-models' / 'G-model.pt')
    return str(exp)


def test_server_matches_jax_server(exp_dir, monkeypatch):
    monkeypatch.setenv('SRCACO2_SWIN_F32_SOFTMAX', '1')
    x = np.random.default_rng(0).integers(0, 256, (3, 1, *LR_HW),
                                          dtype=np.uint8)
    j_out = JSRServer(exp_dir, batch_size=2, lr_hw=LR_HW)(x)
    srv = TSRServer(exp_dir, batch_size=2, lr_hw=LR_HW, device='cpu')
    assert srv.setup_seconds >= 0
    out = srv(x)                  # a batch of 2, then 1 padded to 2
    assert out.shape == (3, 1, 48, 48) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, srv(x))
    diff = np.abs(out.astype(np.int16) - j_out.astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    # tail padding neither drops nor duplicates: the tail image alone
    # gives the same pixels
    np.testing.assert_array_equal(srv(x[2:]), out[2:])
    assert srv.throughput(iters=1) > 0
    with pytest.raises(ValueError, match='uint8'):
        srv(x.astype(np.float32))


def test_entry_points_want_a_card_unless_cpu_is_asked(tmp_path,
                                                     monkeypatch, exp_dir):
    if torch.cuda.is_available():
        pytest.skip('a card is visible: the default device is valid')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_define_g(_args())
    assert resolve_device('cpu').type == 'cpu'
    # the trainer's and the re-scorer's entry points: without --device
    # cpu they raise before any data is read or any step runs
    from srcaco2_tpu_torch import eval as t_eval, main as t_main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_main.main(['--scale', '2', '--n_channels', '1', '--l2', 'True',
                     '--train_dsets', 'caco2_train_X_2_in_256_out_512_cell_'
                     'CELL0', '--data_root', str(tmp_path / 'missing')])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        t_eval.main(['--exp_path', exp_dir])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSRServer(exp_dir, batch_size=1, lr_hw=LR_HW)


def _port_sources():
    files = sorted((ROOT / 'srcaco2_tpu_torch').rglob('*.py'))
    return files + [ROOT / 'chip_smoke.py']


def test_port_names_nothing_of_jax_or_the_jax_package():
    pat = re.compile(r'^\s*(import|from)\s+(jax|flax|optax|orbax|'
                     r'srcaco2_tpu)(\.|\s|$)', re.M)
    hits = [f'{p.relative_to(ROOT)}: {m.group(0).strip()}'
            for p in _port_sources() for m in pat.finditer(p.read_text())]
    assert not hits, hits


def test_port_scan_covers_the_eval_modules():
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {'srcaco2_tpu_torch/ops/window_attention.py',
            'srcaco2_tpu_torch/ops/metrics.py',
            'srcaco2_tpu_torch/train/evaluator.py',
            'srcaco2_tpu_torch/train/steps.py',
            'srcaco2_tpu_torch/models/cnn_pre.py',
            'srcaco2_tpu_torch/models/dfcan.py',
            'srcaco2_tpu_torch/models/mslapsr.py',
            'srcaco2_tpu_torch/models/srfbn.py',
            'srcaco2_tpu_torch/models/enlcn.py',
            'srcaco2_tpu_torch/models/act.py',
            'srcaco2_tpu_torch/models/omnisr.py',
            'srcaco2_tpu_torch/models/nlsn.py',
            'srcaco2_tpu_torch/models/grl.py',
            'srcaco2_tpu_torch/models/dbpn.py',
            'srcaco2_tpu_torch/models/prosr.py',
            'srcaco2_tpu_torch/models/dsr_splines.py',
            'srcaco2_tpu_torch/models/csrcnn.py',
            'srcaco2_tpu_torch/models/edsr_liif.py',
            'srcaco2_tpu_torch/losses/master.py',
            'srcaco2_tpu_torch/inference/serve.py',
            'srcaco2_tpu_torch/ops/patches.py',
            'srcaco2_tpu_torch/parallel/mesh.py',
            'srcaco2_tpu_torch/utils/cluster.py',
            'chip_smoke.py'} <= scanned


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke, imports with jax, flax,
    optax, orbax and srcaco2_tpu made unimportable."""
    code = (
        'import sys, importlib, pkgutil\n'
        'for m in ("jax", "flax", "optax", "orbax", "srcaco2_tpu"):\n'
        '    sys.modules[m] = None\n'
        'import srcaco2_tpu_torch as p\n'
        'for info in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(info.name)\n'
        'import chip_smoke\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == 'ok', res.stderr
