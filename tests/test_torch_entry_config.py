"""The port's command line and config files against the JAX package's:
get_args on the defaults, the README command and list overrides (every
shared key equal; the keys only one side has named), the experiment
directory name, and the YAML-less writer (its JSON reads back equal
through yaml.safe_load, floats such as 1e-5 included, and through the
port's reader without PyYAML)."""
import math

import pytest
import yaml

from srcaco2_tpu.config import parser as JPARSE
from srcaco2_tpu_torch.config import parser as TPARSE
from srcaco2_tpu_torch.config import yaml_io

README = ['--net_type', 'SwinIR', '--scale', '8', '--h_size', '128',
          '--n_channels', '1',
          '--train_dsets', 'caco2_train_X_8_in_64_out_512_cell_CELL2',
          '--valid_dsets', 'caco2_val_X_8_in_64_out_512_cell_CELL2',
          '--test_dsets', 'caco2_test_X_8_in_64_out_512_cell_CELL2',
          '--data_root', '/data', '--splits_root', '/data',
          '--l2', 'True', '--ssim', 'True', '--ssim_lambda', '5.',
          '--ssim_window_s', '19', '--eval_over_roi_also', 'True',
          '--eval_over_roi_also_model_select', 'True',
          '--swinir_upsampler', 'pixelshuffledirect', '--amp', 'True',
          '--batch_size', '64', '--max_epochs', '70']
LISTS = ['--swinir_depths', '[2, 2]', '--swinir_num_heads', '[2, 2]',
         '--G_scheduler_milestones', '[100, 200]',
         '--eval_over_roi_also_ths', '[5, 7]', '--checkpoint_eval', '0.5',
         '--G_optimizer_lr', '1e-5']
CASES = {'defaults': [], 'readme': README, 'lists': README + LISTS}
# the port's own keys; the JAX package has none the port lacks
PORT_ONLY = {'device', 'init_method', 'dist_timeout_s'}


def _flat(d, prefix=''):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k in ('netG', 'train'):
            out.update(_flat(v, f'{k}.'))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_get_args_matches_jax(case):
    j = _flat(JPARSE.get_args(list(CASES[case])))
    t = _flat(TPARSE.get_args(list(CASES[case])))
    assert set(t) - set(j) == PORT_ONLY
    assert set(j) - set(t) == set()
    diff = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not diff, diff
    assert t['device'] == 'cuda'
    if case == 'lists':
        assert t['netG.swinir_depths'] == [2, 2]
        assert t['train.G_scheduler_milestones'] == [100, 200]
        assert t['train.checkpoint_eval'] == 0.5


@pytest.mark.parametrize('case', sorted(CASES))
def test_outfd_matches_jax(case):
    assert TPARSE.outfd(TPARSE.get_args(list(CASES[case])), '/r') == \
        JPARSE.outfd(JPARSE.get_args(list(CASES[case])), '/r')


def test_lists_parse_without_pyyaml(monkeypatch):
    with_yaml = TPARSE.get_args(README + LISTS)
    monkeypatch.setattr(yaml_io, 'yaml', None)
    assert TPARSE.get_args(README + LISTS) == with_yaml


def test_refused_settings_raise(monkeypatch):
    # the port refuses no setting now: the reconstruct task parses as in
    # JAX (a bad task name is refused by the sanity check)
    args = TPARSE.get_args(['--task', 'reconstruct'])
    jargs = JPARSE.get_args(['--task', 'reconstruct'])
    assert (args['task'], args['reconstruct_type'],
            args['reconstruct_input']) == (jargs['task'],
                                           jargs['reconstruct_type'],
                                           jargs['reconstruct_input']) == (
        'reconstruct', 'low_res', 'fake')
    with pytest.raises(ValueError, match='invalid configuration'):
        TPARSE.get_args(['--task', 'denoise'])
    # distributed and scratch_root parse; with no launcher's variables
    # the world is one process: rank 0 of 1, the master, mesh_data 1
    for var in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'SLURM_PROCID',
                'SLURM_NTASKS', 'SLURM_LOCALID', 'MASTER_ADDR'):
        monkeypatch.delenv(var, raising=False)
    args = TPARSE.get_args(['--distributed', 'True', '--scratch_root',
                            '/tmp/scratch', '--device', 'cpu'])
    assert args['distributed'] and args['scratch_root'] == '/tmp/scratch'
    from srcaco2_tpu_torch.parallel import mesh
    try:
        args = TPARSE._setup_process(args)
        assert mesh.is_initialized() and mesh.device_count() == 1
    finally:
        if mesh.is_initialized():
            mesh.destroy_process_group()
    assert (args['rank'], args['world_size'], args['mesh_data']) == (0, 1, 1)
    assert args['is_master'] and args['is_node_master']
    # the options ported since parse: the regularizers, sampling, the
    # local augs, ppiw and the loss terms
    args = TPARSE.get_args(
        ['--G_regularizer_orthstep', '2', '--G_regularizer_clipstep', '3',
         '--sample_tr_patch', 'edt*roi', '--da_blur', 'True', '--ppiw',
         'True', '--l1', 'True', '--hist', 'True', '--kde', 'True',
         '--w_sparsity', 'True'])
    assert args['train']['G_regularizer_orthstep'] == 2
    assert args['sample_tr_patch'] == 'edt*roi' and args['ppiw']
    with pytest.raises(ValueError, match='invalid configuration'):
        TPARSE.get_args(['--scale', '3'])


def _sample():
    cfg = TPARSE.get_args(README + LISTS)
    cfg.update(small=1e-5, tiny=1e-9, big=3e20, neg=-2.5e-7, whole=2.0,
               inf=math.inf, ninf=-math.inf, nested={'a': [1.5e-5, 'x'],
                                                     'b': None},
               tup=(1, 2), empty={}, text='1e-05')
    return cfg


def test_json_writer_reads_back_through_yaml():
    cfg = _sample()
    text = yaml_io.to_json(cfg)
    back = yaml.safe_load(text)
    assert back == {**cfg, 'tup': [1, 2]}
    assert isinstance(back['small'], float) and back['text'] == '1e-05'
    assert '1.0e-05' in text


def test_dump_and_load_without_pyyaml(tmp_path, monkeypatch):
    cfg = _sample()
    monkeypatch.setattr(yaml_io, 'yaml', None)
    path = str(tmp_path / 'config_model.yml')
    yaml_io.dump(cfg, path)
    assert yaml_io.load(path) == {**cfg, 'tup': [1, 2]}
    with open(path) as f:
        assert yaml.safe_load(f) == {**cfg, 'tup': [1, 2]}
    nan = yaml_io.loads(yaml_io.to_json({'v': math.nan}))['v']
    assert math.isnan(nan)
