"""Checkpoints over torch.save / torch.load(weights_only=True) (port of
srcaco2_tpu/train/checkpoint.py).

The JAX package's directory layout, with one `.pt` file in place of each
orbax directory:
  <exp>/models/<step>_G.pt            parameters and persistent buffers
                                      (a state_dict)
  <exp>/models/<step>_optimizerG.pt   {'opt_state', 'step', 'elb_t'}
  <exp>/models/<step>_E.pt            EMA parameters (E_decay > 0)
  <exp>/best-models/G-model.pt        best parameters and buffers (one
                                      validation set; G-<ds>.pt with
                                      several)
`inference/super_res.load_exp` reads best-models/G-model.pt. Resume
finds the largest saved step; GC keeps only the latest. Orbax
checkpoints of the JAX package need jax and are not read here.
"""
import os
import re
from typing import Dict, Optional, Tuple

import torch

from srcaco2_tpu_torch.train.state import TrainState

Tensors = Dict[str, torch.Tensor]


def _models_dir(exp_dir: str) -> str:
    return os.path.abspath(os.path.join(exp_dir, 'models'))


def _save(obj, path: str) -> None:
    """torch.save through a temporary file and a rename, so a run killed
    mid-write leaves no truncated checkpoint under the final name."""
    tmp = path + '.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, device):
    return torch.load(path, map_location=device, weights_only=True)


def _detached(tensors: Tensors) -> Tensors:
    return {k: v.detach() for k, v in tensors.items()}


def copy_into(dst: Tensors, src: Tensors) -> None:
    """Load `src` into the live tensors of `dst` in place (the state's
    params are the model's own parameters)."""
    if set(dst) != set(src):
        raise KeyError(f'checkpoint keys differ: missing '
                       f'{sorted(set(dst) - set(src))}, unexpected '
                       f'{sorted(set(src) - set(dst))}')
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[k])


def save_checkpoint(exp_dir: str, state: TrainState,
                    buffers: Optional[Tensors] = None):
    """The step's params (with the model's persistent `buffers`), the
    optimizer state and the EMA."""
    step = int(state.step)
    md = _models_dir(exp_dir)
    os.makedirs(md, exist_ok=True)
    _save(_detached({**state.params, **(buffers or {})}),
          os.path.join(md, f'{step}_G.pt'))
    _save({'opt_state': state.opt_state, 'step': state.step,
           'elb_t': state.elb_t}, os.path.join(md, f'{step}_optimizerG.pt'))
    if state.ema_params is not None:
        _save(_detached(state.ema_params), os.path.join(md, f'{step}_E.pt'))


def find_last_checkpoint(exp_dir: str) -> int:
    """Largest saved step, 0 if none."""
    md = _models_dir(exp_dir)
    if not os.path.isdir(md):
        return 0
    steps = [int(m.group(1)) for f in os.listdir(md)
             if (m := re.match(r'^(\d+)_G\.pt$', f))]
    return max(steps, default=0)


def load_checkpoint(exp_dir: str, state: TrainState,
                    step: Optional[int] = None,
                    load_optimizer: bool = True,
                    buffers: Optional[Tensors] = None
                    ) -> Tuple[TrainState, int]:
    """Restore the params and `buffers` (and the optimizer state, the
    step and elb_t) saved at `step` (default: the latest) into `state`,
    in place for the params, the buffers and the EMA."""
    step = step if step is not None else find_last_checkpoint(exp_dir)
    if step <= 0:
        return state, 0
    md = _models_dir(exp_dir)
    dev = state.step.device
    copy_into({**state.params, **(buffers or {})},
              _load(os.path.join(md, f'{step}_G.pt'), dev))
    opt_path = os.path.join(md, f'{step}_optimizerG.pt')
    if load_optimizer and os.path.isfile(opt_path):
        aux = _load(opt_path, dev)
        state.opt_state = aux['opt_state']
        state.step = aux['step']
        state.elb_t = aux['elb_t']
    else:
        state.step = torch.tensor(step, dtype=torch.int32, device=dev)
    e_path = os.path.join(md, f'{step}_E.pt')
    if state.ema_params is not None and os.path.isfile(e_path):
        copy_into(state.ema_params, _load(e_path, dev))
    return state, step


def gc_checkpoints(exp_dir: str, keep_step: int):
    """Delete every step's files but `keep_step`'s."""
    md = _models_dir(exp_dir)
    if not os.path.isdir(md):
        return
    for f in os.listdir(md):
        m = re.match(r'^(\d+)_(G|optimizerG|E)\.pt$', f)
        if m and int(m.group(1)) != keep_step:
            os.remove(os.path.join(md, f))


def _best_path(exp_dir: str, ds_name: Optional[str]) -> str:
    name = 'G-model' if ds_name is None else f'G-{ds_name}'
    return os.path.join(os.path.abspath(exp_dir), 'best-models',
                        f'{name}.pt')


def save_best(exp_dir: str, params: Tensors, ds_name: Optional[str] = None):
    """best-models/G-model.pt (one validation set) or G-<ds>.pt (several)."""
    path = _best_path(exp_dir, ds_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _save(_detached(params), path)


def load_best(exp_dir: str, device, ds_name: Optional[str] = None
              ) -> Tensors:
    """The best parameters, as a state_dict on `device`; with a dataset
    name whose file is missing, G-model.pt."""
    path = _best_path(exp_dir, ds_name)
    if not os.path.isfile(path) and ds_name is not None:
        path = _best_path(exp_dir, None)
    return _load(path, device)


def load_params(path: str, template: Tensors) -> Tensors:
    """A state_dict saved at `path`, strictly: the same names and shapes
    as `template`, on its devices and in its dtypes."""
    raw = _load(path, 'cpu')
    if set(raw) != set(template):
        raise KeyError(f'{path}: keys differ from the model\'s')
    out = {}
    for k, t in template.items():
        if raw[k].shape != t.shape:
            raise ValueError(f'{path}: {k} {tuple(raw[k].shape)} != '
                             f'{tuple(t.shape)}')
        out[k] = raw[k].to(device=t.device, dtype=t.dtype)
    return out


def load_params_nonstrict(path: str, template: Tensors) -> Tensors:
    """Non-strict load: tensors of `path` whose names and shapes match
    the template's are taken, everything else keeps the template's
    value."""
    raw = _load(path, 'cpu')
    return {k: (raw[k].to(device=t.device, dtype=t.dtype)
                if k in raw and raw[k].shape == t.shape else t)
            for k, t in template.items()}
