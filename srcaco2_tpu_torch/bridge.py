"""flax SwinIR params -> the port's state_dict (the inverse direction of
srcaco2_tpu/diagnosis/torch_port.py:port_swinir).

Leaves are matched by name, never by order:
  * conv kernels (kh, kw, I, O) become (O, I, kh, kw);
  * LayerNorm `scale` becomes `weight` (patch_norm, the final norm and
    the stacked block LNs ln1/ln2);
  * dense kernels keep the flax (in, out) layout: the port's
    FusedBlockStack computes `x @ kernel`, so nothing is transposed;
  * stacked block leaves come either under stages/RSTB_0/blocks/<leaf>
    stacked (S, d, ...) (uniform stages, scanned) or under
    rstb{i}/blocks/<leaf> stacked (d, ...); both land on
    stages.{s}.blocks.<leaf>.
Any flax leaf that maps to no port parameter, any port parameter left
unfilled, and any shape mismatch raise.

`optax_to_torch` carries an optax chain state (the Adam moments, its
count and the schedule count) into the port's optimizer state
(train/schedule.py) by the same name mapping.
"""
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_name(leaf: str) -> str:
    return {'kernel': 'weight', 'scale': 'weight'}.get(leaf, leaf)


_TOP = {'conv_first': 'conv_first', 'conv_after_body': 'conv_after_body',
        'conv_before_up': 'conv_before_up', 'conv_last': 'conv_last',
        'patch_norm': 'patch_norm', 'LayerNorm_0': 'norm'}


def _targets(path: Tuple[str, ...], value: np.ndarray):
    """[(port name, array)] for one flax leaf, or None if unmapped."""
    ks = '/'.join(path)
    leaf = path[-1]
    conv = leaf == 'kernel' and value.ndim >= 4

    def arr(a):
        return a.transpose(3, 2, 0, 1) if conv else a

    if path[0] in _TOP and len(path) <= 3:
        return [(f'{_TOP[path[0]]}.{_leaf_name(leaf)}', arr(value))]
    m = re.fullmatch(r'Upsampler_0/Conv_(\d+)/Conv_0/(kernel|bias)', ks)
    if m:
        return [(f'upsample.convs.{m.group(1)}.{_leaf_name(leaf)}',
                 arr(value))]
    if re.fullmatch(r'UpsamplerDirect_0/Conv_0/Conv_0/(kernel|bias)', ks):
        return [(f'upsample.conv.{_leaf_name(leaf)}', arr(value))]
    m = re.fullmatch(r'Conv_(\d+)/Conv_0/(kernel|bias)', ks)
    if m:
        return [(f'nearest.{m.group(1)}.{_leaf_name(leaf)}', arr(value))]

    def stage_leaf(rest: str):
        m = re.fullmatch(r'blocks/(\w+)', rest)
        if m:
            return 'blocks.' + m.group(1).replace('_scale', '_weight')
        m = re.fullmatch(r'Conv_(\d+)/Conv_0/(kernel|bias)', rest)
        if m:
            return f'convs.{m.group(1)}.{_leaf_name(m.group(2))}'
        return None

    m = re.fullmatch(r'stages/RSTB_0/(.+)', ks)
    if m and stage_leaf(m.group(1)):
        name = stage_leaf(m.group(1))
        return [(f'stages.{s}.{name}', arr(value[s]))
                for s in range(value.shape[0])]
    m = re.fullmatch(r'rstb(\d+)/(.+)', ks)
    if m and stage_leaf(m.group(2)):
        return [(f'stages.{m.group(1)}.{stage_leaf(m.group(2))}',
                 arr(value))]
    return None


def flax_to_torch(params_np: Dict, model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax SwinIR, fused_blocks=True) ->
    state_dict for `model` (f32 CPU tensors; load_state_dict moves them
    to the model's device)."""
    want = model.state_dict()
    out = {}
    for path, value in _flatten(params_np):
        value = np.asarray(value, np.float32)
        targets = _targets(path, value)
        if targets is None:
            raise KeyError(f'unmapped flax param {"/".join(path)}')
        for name, a in targets:
            if name not in want:
                raise KeyError(f'flax param {"/".join(path)} maps to '
                               f'{name}, which the model does not have')
            if name in out:
                raise KeyError(f'{name} filled twice')
            if tuple(a.shape) != tuple(want[name].shape):
                raise ValueError(f'{name}: flax {a.shape} vs model '
                                 f'{tuple(want[name].shape)}')
            out[name] = torch.from_numpy(np.array(a, np.float32))
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f'model params not filled from flax: {missing}')
    return out


def _fields(state):
    return tuple(getattr(state, '_fields', ()))


def optax_to_torch(opt_state, model: nn.Module, template: dict) -> dict:
    """An optax chain state as nested numpy-convertible leaves (the
    tuple of clip / add_decayed_weights / ScaleByAdamState or
    ScaleByAmsgradState or TraceState / ScaleByScheduleState states of
    srcaco2_tpu/train/schedule.py:build_optimizer) -> the port's
    optimizer state, shaped like `template` (the port's tx.init(params)
    for `model`). Moment trees are mapped as flax_to_torch maps params;
    counts become int32 scalars. Any optax leaf the port has no place
    for, and any place of the template left unfilled, raise. Tensors
    are CPU f32 / int32; move them with the model."""
    out = {}

    def put(section, key, value):
        if section not in template or key not in template[section]:
            raise KeyError(f'optax state {section}.{key} has no place in '
                           'the port optimizer state')
        if key in out.setdefault(section, {}):
            raise KeyError(f'{section}.{key} filled twice')
        out[section][key] = value

    def count(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32)

    for st in opt_state:
        names = _fields(st)
        if not names:           # EmptyState of clip / weight decay
            continue
        if names in (('count', 'mu', 'nu'), ('count', 'mu', 'nu', 'nu_max')):
            put('adam', 'count', count(st.count))
            for key in names[1:]:
                put('adam', key, flax_to_torch(getattr(st, key), model))
        elif names == ('trace',):
            put('trace', 'trace', flax_to_torch(st.trace, model))
        elif names == ('count',):
            put('schedule', 'count', count(st.count))
        else:
            raise KeyError(f'unmapped optax state {type(st).__name__} '
                           f'{names}')
    for section, entries in template.items():
        for key, ref in entries.items():
            if key not in out.get(section, {}):
                raise KeyError(f'port optimizer state {section}.{key} not '
                               'filled from optax')
            got = out[section][key]
            if isinstance(ref, dict) and set(got) != set(ref):
                raise KeyError(f'{section}.{key}: names differ from the '
                               'model parameters')
    return out
