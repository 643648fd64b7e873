"""flax params -> the port's state_dict (for SwinIR the inverse direction
of srcaco2_tpu/diagnosis/torch_port.py:port_swinir).

Leaves are matched by name, never by order. The zoo nets (every ported
net but SwinIR) name their submodules after the flax auto-names, so one
rule covers them: the flax path joined by dots, where
  * the inner conv of the blocks' `Conv`, `StridedConv` and `ConvT`
    wrappers (`.../Conv_0/kernel`, `.../ConvTranspose_0/kernel`) lands on
    the wrapper itself, and an Upsampler's `Conv_<i>` on `convs.<i>`;
  * conv kernels (kh, kw, I, O) become (O, I, kh, kw); transposed-conv
    kernels (flax's nn.ConvTranspose, transpose_kernel=False) are flipped
    in both spatial axes and become (I, O, kh, kw), the layout torch's
    conv_transpose2d reads (models/blocks.py:ConvT);
  * dense kernels keep flax's (in, out) layout, LayerNorm `scale`
    becomes `weight`, PReLU's `negative_slope`, the relative position
    bias tables and OmniSR's `temperature` keep their names;
  * ENLCN's projection buffers (ENLCA.proj), which are no flax params
    (JAX draws the matrix on every call), are filled from `projection`
    when it is given;
  * the BatchNorm running statistics (MemNet), flax's `batch_stats`
    collection (`.../BatchNorm_<i>/{mean,var}`), fill the buffers of the
    same names from `model_state` when it is given;
  * a remat lift level (`Checkpoint_MemChain_0`, flax's nn.remat of a
    submodule) is the submodule itself (`_MemChain_0`): torch's
    checkpoint renames nothing;
  * GRL's scanned block pairs (`s{i}_blocks/GRLBlock_{m}/...`, stacked
    (d/2, ...)) unstack onto the blocks `s{i}_b{2p + m}`; DRRN's shared
    `rec1` / `rec2` are one conv each on both sides;
  * DSR-Splines' vmapped bank (`splines/Conv_<n>`, an (S, kh, kw, I, O)
    kernel and an (S, O) bias) lands on one batched conv whose output
    channel s * O + o is branch s's o: (S * O, I, kh, kw) and (S * O,)
    (models/dsr_splines.py).
SwinIR's leaves:
  * conv kernels (kh, kw, I, O) become (O, I, kh, kw);
  * LayerNorm `scale` becomes `weight` (patch_norm, the final norm and
    the stacked block LNs ln1/ln2);
  * dense kernels keep the flax (in, out) layout: the port computes
    `x @ kernel`, so nothing is transposed;
  * a stage's leaves come under stages/RSTB_0/... with a leading stage
    axis (uniform stages, scanned) or under rstb{s}/...; both land on
    stages.{s}....;
  * fused blocks (swinir_use_fused_blocks): blocks/<leaf> stacked
    (d, ...) lands on stages.{s}.blocks.<leaf>;
  * unfused blocks: blocks/SwinBlock_{m}/<path> stacked (d/2, ...) (even
    depth: scanned pairs, member m of pair p is block 2p + m) or
    SwinBlock_{i}/<path> (odd depth, unrolled) land on
    stages.{s}.blocks.{i}.{norm1, attn.qkv, attn.proj,
    attn.rel_pos_bias, norm2, fc1, fc2}.
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


# leaves of one unfused SwinBlock: flax path -> port name
_BLOCK = {'LayerNorm_0': 'norm1', 'LayerNorm_1': 'norm2',
          'WindowAttention_0/qkv': 'attn.qkv',
          'WindowAttention_0/proj': 'attn.proj',
          'Dense_0': 'fc1', 'Dense_1': 'fc2'}


def _block_leaf(rest: str):
    """Port leaf name (under blocks.{i}.) of a path inside one SwinBlock,
    or None."""
    if rest == 'WindowAttention_0/rel_pos_bias':
        return 'attn.rel_pos_bias'
    mod, _, leaf = rest.rpartition('/')
    if mod in _BLOCK and leaf in ('kernel', 'scale', 'bias'):
        return f'{_BLOCK[mod]}.{_leaf_name(leaf)}'
    return None


def _conv(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _stage_targets(s: int, rest: str, value: np.ndarray):
    """[(port name, array)] of one stage's leaf (its stage axis already
    taken off), or None if unmapped."""
    m = re.fullmatch(r'Conv_(\d+)/Conv_0/(kernel|bias)', rest)
    if m:
        return [(f'stages.{s}.convs.{m.group(1)}.{_leaf_name(m.group(2))}',
                 _conv(value))]
    m = re.fullmatch(r'blocks/(\w+)', rest)
    if m:       # fused: one stacked (d, ...) leaf
        return [(f'stages.{s}.blocks.'
                 + m.group(1).replace('_scale', '_weight'), value)]
    m = re.fullmatch(r'blocks/SwinBlock_([01])/(.+)', rest)
    if m and _block_leaf(m.group(2)):
        # unfused, even depth: scanned (no-shift, shift) pairs stacked
        # (d/2, ...); member m of pair p is block 2p + m
        name = _block_leaf(m.group(2))
        return [(f'stages.{s}.blocks.{2 * p + int(m.group(1))}.{name}',
                 value[p]) for p in range(value.shape[0])]
    m = re.fullmatch(r'SwinBlock_(\d+)/(.+)', rest)
    if m and _block_leaf(m.group(2)):   # unfused, odd depth: unrolled
        return [(f'stages.{s}.blocks.{m.group(1)}.{_block_leaf(m.group(2))}',
                 value)]
    return None


def _targets(path: Tuple[str, ...], value: np.ndarray):
    """[(port name, array)] for one flax leaf, or None if unmapped."""
    ks = '/'.join(path)
    leaf = path[-1]
    if path[0] in _TOP and len(path) <= 3:
        return [(f'{_TOP[path[0]]}.{_leaf_name(leaf)}', _conv(value))]
    m = re.fullmatch(r'Upsampler_0/Conv_(\d+)/Conv_0/(kernel|bias)', ks)
    if m:
        return [(f'upsample.convs.{m.group(1)}.{_leaf_name(leaf)}',
                 _conv(value))]
    if re.fullmatch(r'UpsamplerDirect_0/Conv_0/Conv_0/(kernel|bias)', ks):
        return [(f'upsample.conv.{_leaf_name(leaf)}', _conv(value))]
    m = re.fullmatch(r'Conv_(\d+)/Conv_0/(kernel|bias)', ks)
    if m:
        return [(f'nearest.{m.group(1)}.{_leaf_name(leaf)}', _conv(value))]
    m = re.fullmatch(r'stages/RSTB_0/(.+)', ks)
    if m:       # uniform stages, scanned: a leading stage axis
        outs = [_stage_targets(s, m.group(1), value[s])
                for s in range(value.shape[0])]
        return None if None in outs else [t for o in outs for t in o]
    m = re.fullmatch(r'rstb(\d+)/(.+)', ks)
    if m:
        return _stage_targets(int(m.group(1)), m.group(2), value)
    return None


_WRAPPED = ('Conv_0', 'ConvTranspose_0')


def _zoo_targets(path: Tuple[str, ...], value: np.ndarray,
                 model: nn.Module, want: Dict):
    """[(port name, array)] of one flax leaf of a zoo net."""
    from srcaco2_tpu_torch.models.blocks import ConvT
    mods = list(path[:-1])
    for j in range(len(mods) - 1):
        if mods[j].startswith('Upsampler_') and \
                re.fullmatch(r'Conv_\d+', mods[j + 1]):
            mods[j + 1] = 'convs.' + mods[j + 1].split('_')[1]
    leaf = _leaf_name(path[-1])
    name = '.'.join(mods + [leaf])
    if name not in want and mods and mods[-1] in _WRAPPED:
        name = '.'.join(mods[:-1] + [leaf])
    if value.ndim == 4:
        owner = model.get_submodule(name.rpartition('.')[0]) \
            if name in want else None
        if isinstance(owner, ConvT):
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            value = _conv(value)
    elif value.ndim == 5:       # a vmapped bank's (S, kh, kw, I, O) kernel
        s_, kh, kw, i, o = value.shape
        value = value.transpose(0, 4, 3, 1, 2).reshape(s_ * o, i, kh, kw)
    elif value.ndim == 2 and leaf == 'bias':    # and its (S, O) bias
        value = value.reshape(-1)
    return [(name, value)]


def _zoo_leaves(tree) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """A zoo net's flax leaves under the port's module path: remat lift
    levels taken off, GRL's scanned pairs unstacked."""
    for path, value in _flatten(tree):
        path = tuple(re.sub(r'^Checkpoint(\w+_\d+)$', r'\1', p)
                     for p in path)
        m = re.fullmatch(r's(\d+)_blocks', path[0])
        b = re.fullmatch(r'GRLBlock_([01])', path[1]) if m and \
            len(path) > 2 else None
        if b:
            value = np.asarray(value)
            for p in range(value.shape[0]):
                blk = f's{m.group(1)}_b{2 * p + int(b.group(1))}'
                yield (blk,) + path[2:], value[p]
        else:
            yield path, value


def flax_to_torch(params_np: Dict, model: nn.Module,
                  projection=None, model_state=None
                  ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a flax param tree, or a tree of the
    same structure: grads, optimizer moments) -> {name: tensor} for
    `model`'s parameters (f32 CPU tensors; load_state_dict moves them
    to the model's device), plus ENLCN's projection buffers filled from
    `projection` (the (nb_features, C/4) matrix of
    srcaco2_tpu/models/enlcn.py:gaussian_orthogonal_random_matrix) when
    it is given, and the BatchNorm statistics from `model_state` (flax's
    mutable collections, {'batch_stats': ...}, or the batch_stats tree)
    when it is given."""
    from srcaco2_tpu_torch.models.swinir import SwinIR
    want = {k: v for k, v in model.named_parameters()}
    out = {}
    leaves = list(_flatten(params_np) if isinstance(model, SwinIR)
                  else _zoo_leaves(params_np))
    if model_state is not None:
        stats = model_state.get('batch_stats', model_state)
        want.update({k: v for k, v in model.named_buffers()
                     if k.rsplit('.', 1)[-1] in ('mean', 'var')})
        leaves += list(_zoo_leaves(stats))
    if projection is not None:
        proj = np.asarray(projection, np.float32)
        for k, v in model.named_buffers():
            if k == 'proj' or k.endswith('.proj'):
                if tuple(proj.shape) != tuple(v.shape):
                    raise ValueError(f'{k}: projection {proj.shape} vs '
                                     f'model {tuple(v.shape)}')
                want[k] = v
                out[k] = torch.from_numpy(np.array(proj))
    for path, value in leaves:
        value = np.asarray(value, np.float32)
        if isinstance(model, SwinIR):
            targets = _targets(path, value)
        else:
            targets = _zoo_targets(path, value, model, want)
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


def orth_kernels(model: nn.Module):
    """The port parameters that the JAX package holds as 4-D flax
    `kernel` leaves, the leaves its regularizer_orth acts on: for each
    leaf, [names] stacked along the leaf's leading axes (in order) and
    their kind, 'conv' ((O, I, kh, kw) of flax's (kh, kw, I, O)),
    'convT' ((I, O, kh, kw) of flax's (kh, kw, I, O) flipped) or 'dense'
    (flax's own (in, out)). Kernels that JAX stacks or vmaps to 5 axes
    (a scanned stage's convs, GRL's scanned block pairs, DSR-Splines'
    bank) are not 4-D leaves, so JAX's test leaves them out; the dense
    kernels of SwinIR's scanned block pairs inside scanned stages stack
    to (stages, pairs, in, out), 4 axes, and JAX's test takes them."""
    from srcaco2_tpu_torch.models.blocks import ConvT
    from srcaco2_tpu_torch.models.dsr_splines import SplineBank
    from srcaco2_tpu_torch.models.grl import GRL
    from srcaco2_tpu_torch.models.swinir import SwinIR
    params = dict(model.named_parameters())
    skip = [n + '.' for n, m in model.named_modules()
            if isinstance(m, SplineBank)]
    out = []
    if isinstance(model, GRL):
        skip += [f's{si}_b{i}.' for si, d in enumerate(model.depths)
                 if d % 2 == 0 for i in range(d)]
    if isinstance(model, SwinIR):
        scanned = (len(model.depths) > 1 and len(set(model.depths)) == 1
                   and len(set(model.num_heads)) == 1)
        # scanned stages: every stage leaf has a leading stage axis
        skip += ['stages.'] if scanned else \
            [f'stages.{s}.blocks.' for s in range(len(model.depths))]
        if scanned and not model.fused_blocks and model.depths[0] % 2 == 0:
            half = model.depths[0] // 2
            for leaf in ('attn.qkv', 'attn.proj', 'fc1', 'fc2'):
                for m in (0, 1):
                    out.append(([f'stages.{s}.blocks.{2 * p + m}.{leaf}'
                                 f'.weight'
                                 for s in range(len(model.depths))
                                 for p in range(half)], 'dense'))
    for name, p in params.items():
        if p.ndim != 4 or any(name.startswith(s) for s in skip):
            continue
        owner = model.get_submodule(name.rpartition('.')[0])
        out.append(([name], 'convT' if isinstance(owner, ConvT) else 'conv'))
    return out


def kernel_to_flax(w: torch.Tensor, kind: str) -> torch.Tensor:
    """A port weight in its flax layout (orth_kernels' kinds)."""
    if kind == 'conv':
        return w.permute(2, 3, 1, 0)
    if kind == 'convT':
        return w.permute(2, 3, 0, 1).flip(0, 1)
    return w


def kernel_from_flax(a: torch.Tensor, kind: str) -> torch.Tensor:
    """kernel_to_flax's inverse."""
    if kind == 'conv':
        return a.permute(3, 2, 0, 1)
    if kind == 'convT':
        return a.flip(0, 1).permute(2, 3, 0, 1)
    return a
