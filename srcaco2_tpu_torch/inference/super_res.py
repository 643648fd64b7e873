"""Experiment loading (port of srcaco2_tpu/inference/super_res.py:load_exp).

The port reads a torch state_dict at <exp>/best-models/G-model.pt (for
example one written from flax params by bridge.flax_to_torch); orbax
checkpoints need jax and are not read here.
"""
import os

import torch

from srcaco2_tpu_torch import resolve_device


def load_exp(exp_path: str, device=None):
    """(model, args) of a trained experiment dir, weights loaded, on
    `device` (default cuda)."""
    import yaml     # not installed everywhere; only this path reads YAML
    from srcaco2_tpu_torch.models.registry import define_g
    with open(os.path.join(exp_path, 'config_model.yml')) as f:
        args = yaml.safe_load(f)
    args['is_train'] = False
    args['distributed'] = False
    device = resolve_device(device)
    model = define_g(args, device)
    state = torch.load(os.path.join(exp_path, 'best-models', 'G-model.pt'),
                       map_location=device, weights_only=True)
    model.load_state_dict(state)
    return model, args
