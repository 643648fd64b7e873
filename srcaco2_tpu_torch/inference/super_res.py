"""Experiment loading (port of srcaco2_tpu/inference/super_res.py:load_exp).

The port reads the experiment's config_model.yml through its own config
reader (config/yaml_io: PyYAML where it imports, JSON otherwise) and the
torch state_dict at <exp>/best-models/G-model.pt, as the port's trainer
writes them (a state_dict written from flax params by
bridge.flax_to_torch reads as well); orbax checkpoints need jax and are
not read here.
"""
import os

import torch

from srcaco2_tpu_torch import resolve_device
from srcaco2_tpu_torch.config import yaml_io


def load_exp(exp_path: str, device=None):
    """(model, args) of a trained experiment dir, weights loaded, on
    `device` (default cuda)."""
    from srcaco2_tpu_torch.models.registry import define_g
    args = yaml_io.load(os.path.join(exp_path, 'config_model.yml'))
    args['is_train'] = False
    args['distributed'] = False
    device = resolve_device(device)
    model = define_g(args, device)
    state = torch.load(os.path.join(exp_path, 'best-models', 'G-model.pt'),
                       map_location=device, weights_only=True)
    model.load_state_dict(state)
    return model, args
