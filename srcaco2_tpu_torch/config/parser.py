"""Command line, experiment directory and process set-up (port of
srcaco2_tpu/config/parser.py).

The same flag surface: one flag per config key (nested `netG` / `train`
keys included), generated from the config dict and overlaid back into
it; the reference CLI's CUDA / DDP flags are accepted and ignored, but
for --init_method, the process group's rendezvous. Lists given on the
command line (`--swinir_depths "[2, 2]"`, `--G_scheduler_milestones
"[100, 200]"`) parse without PyYAML (config/yaml_io.parse_value).

The process set-up: one process, or with `--distributed True` one
process per card under torchrun (RANK, WORLD_SIZE, LOCAL_RANK; or
SLURM's SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID), over NCCL on the
card and gloo on the CPU (parallel/mesh.py). Each rank runs on
cuda:LOCAL_RANK. Only the master writes the experiment directory.
"""
import argparse
import datetime as dt
import os
import sys
from typing import Any, Dict, Optional

import torch

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.config.defaults import get_config
from srcaco2_tpu_torch.config.net_defaults import NET_OPTIONS, safe_str_var
from srcaco2_tpu_torch.parallel import mesh


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError(f'Boolean value expected, got {v!r}.')


_SKIP_FLAGS = {'fd_exp', 'abs_fd_exp', 't0', 'tend', 'running_time',
               'multi_valid', 'is_master', 'is_node_master', 'rank',
               'world_size', 'method'}


def _int_or_float(v: str):
    """int when integral, float otherwise (checkpoint_eval/save take
    iterations or an epoch fraction; sample_tr_patch_th may also be the
    'automatic_threshold' sentinel string)."""
    try:
        f = float(v)
    except ValueError:
        return v
    return int(f) if f == int(f) and '.' not in v else f


_NUMERIC_FLAGS = {'checkpoint_eval', 'checkpoint_save',
                  'sample_tr_patch_th'}


def _add_flag(parser: argparse.ArgumentParser, name: str, default: Any):
    if name in _SKIP_FLAGS:
        return
    if name in _NUMERIC_FLAGS:
        parser.add_argument(f'--{name}', type=_int_or_float, default=None)
    elif isinstance(default, bool):
        parser.add_argument(f'--{name}', type=_str2bool, default=None)
    elif isinstance(default, int):
        parser.add_argument(f'--{name}', type=int, default=None)
    elif isinstance(default, float):
        parser.add_argument(f'--{name}', type=float, default=None)
    elif isinstance(default, (str, list, dict)) or default is None:
        # lists and dicts arrive as YAML / JSON strings (_coerce)
        parser.add_argument(f'--{name}', type=str, default=None)
    else:
        raise NotImplementedError(f'{name}: {type(default)}')


# reference-CLI compatibility: CUDA/DDP flags accepted and ignored so
# commands copied from the reference README run unchanged.
_IGNORED_COMPAT_FLAGS = ['cudaid', 'num_gpus', 'local_rank',
                         'local_world_size', 'c_cudaid']


def build_parser(config: dict) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='srcaco2_tpu_torch.main')
    for name in _IGNORED_COMPAT_FLAGS:
        parser.add_argument(f'--{name}', type=str, default=None,
                            help='accepted for reference-CLI '
                                 'compatibility; ignored')
    seen = set(_IGNORED_COMPAT_FLAGS)
    for k, v in config.items():
        if k in ('netG', 'train'):
            continue
        _add_flag(parser, k, v)
        seen.add(k)
    for sub in ('netG', 'train'):
        for k, v in config[sub].items():
            if k in seen:
                continue
            _add_flag(parser, k, v)
            seen.add(k)
    # the net's options that its defaults leave unset (srfbn_remat_steps)
    for k, v in NET_OPTIONS.get(config['netG']['net_type'], {}).items():
        if k not in seen:
            _add_flag(parser, k, v)
            seen.add(k)
    return parser


def _coerce(default: Any, raw: Any) -> Any:
    if isinstance(default, (list, dict)) and isinstance(raw, str):
        return yaml_io.parse_value(raw)
    return raw


def overlay(config: dict, cli: Dict[str, Any]) -> dict:
    """Write parsed CLI values back into the nested config dict."""
    for k, v in cli.items():
        if v is None:
            continue
        if k in config and k not in ('netG', 'train'):
            config[k] = _coerce(config[k], v)
        elif k in config['netG']:
            config['netG'][k] = _coerce(config['netG'][k], v)
        elif k in config['train']:
            config['train'][k] = _coerce(config['train'][k], v)
        elif k in NET_OPTIONS.get(config['netG']['net_type'], {}):
            config['netG'][k] = v
    return config


def _derive(config: dict) -> dict:
    """Derived keys: the net's scale, patch size and channels follow the
    top-level ones; multi_valid with several validation datasets."""
    nt = config['netG']['net_type']
    snt = safe_str_var(nt)
    ng = config['netG']
    if f'{snt}_upscale' in ng:
        ng[f'{snt}_upscale'] = config['scale']
    if f'{snt}_img_size' in ng:
        ng[f'{snt}_img_size'] = config['h_size'] // config['scale']
    if f'{snt}_in_chans' in ng:
        ng[f'{snt}_in_chans'] = config['n_channels']
    if f'{snt}_in_planes' in ng:
        ng[f'{snt}_in_planes'] = config['n_channels']
    config['method'] = constants.NETTYPE_METHOD[nt]
    vd = [s for s in str(config['valid_dsets']).split('+') if s]
    config['multi_valid'] = len(vd) > 1
    return config


def _check(cond: bool, what) -> None:
    if not cond:
        raise ValueError(f'invalid configuration: {what}')


def _sanity(config: dict):
    """The JAX package's sanity checks (as ValueError, not assert), and
    the settings the port refuses."""
    _check(config['task'] in constants.TASKS, config['task'])
    _check(config['scale'] in constants.SCALES, config['scale'])
    _check(config['h_size'] % config['scale'] == 0,
           (config['h_size'], config['scale']))
    _check(config['n_channels'] in (1, 3), config['n_channels'])
    _check(config['netG']['net_type'] in constants.MODELS,
           config['netG']['net_type'])
    _check(0. < config['train_n'] <= 1., config['train_n'])
    _check(config['model_select_mtr'] in constants.METRICS,
           config['model_select_mtr'])
    _check(config['sample_tr_patch'] in constants.SAMPLE_PATCHES,
           config['sample_tr_patch'])
    tr = config['train']
    _check(tr['G_optimizer_type'] in constants.OPTIMIZERS,
           tr['G_optimizer_type'])
    _check(tr['G_scheduler_type'] in constants.STEPSLR,
           tr['G_scheduler_type'])
    for key in ('checkpoint_eval', 'checkpoint_save'):
        v = tr[key]
        ok = (isinstance(v, int) and v > 0) or \
             (isinstance(v, float) and 0. < v <= 1.)
        _check(ok, f'{key}={v}')
    if config['ssim']:
        _check(config['ssim_window_s'] % 2 == 1, config['ssim_window_s'])
    if config['task'] == constants.RECONSTRUCT:
        raise NotImplementedError(
            'the reconstruct task: not ported yet (see ROADMAP.md)')


def outfd(config: dict, root: Optional[str] = None) -> str:
    """Experiment directory naming:
    exps/<debug_subfolder>/<task>/<net>/<train_dsets>/<tagged-id>."""
    tag = [('id', config['exp_id']),
           ('tsk', config['task']),
           ('x', config['scale']),
           ('netG', config['netG']['net_type']),
           ('sd', config['myseed'])]
    for loss_flag in ('l1', 'l2', 'l2sum', 'ssim', 'charbonnier'):
        if config.get(loss_flag):
            tag.append((loss_flag, 'yes'))
    subpath = '-'.join(f'{k}_{v}' for k, v in tag)
    parts = ['exps']
    if config['debug_subfolder']:
        parts.append(config['debug_subfolder'])
    parts += [config['task'], config['netG']['net_type'],
              config['train_dsets'] or 'none', subpath]
    fd = os.path.join(*parts)
    if root:
        fd = os.path.join(root, fd)
    return fd


def _setup_process(config: dict) -> dict:
    """The process's place in the job: rank, world_size, is_master (rank
    0), is_node_master (local rank 0) and mesh_data (-1 resolved to
    world_size // mesh_model, as JAX does). With `distributed` the
    world comes from the launcher (parallel/mesh.launcher_world: a
    world of one without one), the rank takes cuda:LOCAL_RANK (the
    config's `device` becomes it) and joins the process group: NCCL on
    the card, gloo on the CPU, the config's init_method and
    dist_timeout_s. A failing NCCL raises; nothing falls back to gloo or
    the CPU."""
    rank, world, local = 0, 1, 0
    if config['distributed']:
        rank, world, local = mesh.launcher_world()
        dev = resolve_device(config.get('device'))
        if dev.type == 'cuda':
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f'local rank {local} but {torch.cuda.device_count()} '
                    f'visible cards')
            torch.cuda.set_device(local)
            dev = torch.device('cuda', local)
            config['device'] = str(dev)
        if not mesh.is_initialized():
            mesh.init_process_group(
                'nccl' if dev.type == 'cuda' else 'gloo', rank, world,
                config.get('init_method', ''),
                config.get('dist_timeout_s', 1800), dev)
    config['rank'] = rank
    config['world_size'] = world
    config['is_master'] = rank == 0
    config['is_node_master'] = local == 0
    if config['mesh_data'] == -1:
        config['mesh_data'] = max(1, world // max(1, config['mesh_model']))
    return config


def get_args(argv=None, net_type: Optional[str] = None) -> dict:
    """defaults -> per-net defaults -> CLI overlay -> derived -> sanity."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument('--net_type', type=str, default=None)
    pre_ns, _ = pre.parse_known_args(argv)
    nt = net_type or pre_ns.net_type or constants.SWINIR
    config = get_config(nt)
    parser = build_parser(config)
    ns = parser.parse_args(argv)
    config = overlay(config, vars(ns))
    config = _derive(config)
    _sanity(config)
    return config


def parse_input(argv=None, eval_mode: bool = False) -> dict:
    """Parse, set up the process, create the exp dir, write config.yml
    and cmd.sh (the master), start the logger; the resolved config.
    Every rank exits 0 when the experiment's `passed.txt` exists (it is
    done), before it joins the process group. The JAX package also
    returns an attribute view of the dict, which nothing here reads."""
    config = get_args(argv)
    fd = outfd(config)
    config['fd_exp'] = fd
    config['abs_fd_exp'] = os.path.abspath(os.path.join(os.getcwd(), fd))
    config['t0'] = dt.datetime.now().isoformat()
    sentinel = os.path.join(config['abs_fd_exp'], 'passed.txt')
    if not eval_mode and os.path.isfile(sentinel):
        print(f'Experiment already completed ({sentinel}); exiting.')
        sys.exit(0)
    config = _setup_process(config)

    if config['is_master'] and not eval_mode:
        os.makedirs(config['abs_fd_exp'], exist_ok=True)
        yaml_io.dump(config, os.path.join(config['abs_fd_exp'],
                                          'config.yml'))
        with open(os.path.join(config['abs_fd_exp'], 'cmd.sh'), 'w') as f:
            f.write('#!/usr/bin/env bash\n')
            f.write('python -m srcaco2_tpu_torch.main '
                    + ' '.join(sys.argv[1:] if argv is None else argv)
                    + '\n')

    from srcaco2_tpu_torch.utils.logger import DLLogger
    DLLogger.init(outdir=config['abs_fd_exp'],
                  is_master=config['is_master'], verbose=config['verbose'])
    return config
