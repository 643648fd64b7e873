"""Port reference (torch) state_dicts into the port's nets (port of
srcaco2_tpu/diagnosis/torch_port.py): the loader of the reference's
published pretrained weights.

The JAX package re-lays the reference's tensors out onto a flax param
tree; the port does the same in numpy, onto a flax-layout TEMPLATE of
its own net (`flax_template`: the paths, shapes and order that JAX's
`flatten_dict(model.init(...)['params'])` gives for the same config),
and then loads the tree through `bridge.flax_to_torch`, the same name
mapping that carries JAX's own params into the port. So the port ends
with exactly the parameters that JAX's `port_*` + `bridge.flax_to_torch`
give.

  torch Conv2d  weight (O, I, kh, kw) -> flax Conv   kernel (kh, kw, I, O)
  torch ConvT2d weight (I, O, kh, kw) -> flax ConvT  kernel (kh, kw, I, O)
  torch Linear  weight (O, I)         -> flax Dense  kernel (I, O)
  1-D tensors (biases, LN/BN scales, PReLU slopes)   -> unchanged
  2-D non-layer tensors (bias tables)                -> unchanged

Matching is ORDER-based for most nets (`port_state_dict`): flax param
dicts keep module-creation order, torch `named_parameters()` yields
registration order, and for these architectures the sequences align
1:1. Every match is shape-checked after re-layout. Inside a lifted flax
transform (nn.scan, nn.vmap, nn.remat) the param dict comes back sorted
by key, which is why SwinIR (`port_swinir`), GRL (`port_grl`) and
DSR-Splines (`port_dsr_splines`) are ported by NAME, and why DBPN and
MemNet are ported with their remat lifts off (`port_dbpn`; MemNet's
`memnet_remat_passes=False`): the remat lift would sort the dict and
DBPN's identically-shaped blocks would mis-pair without tripping the
shape check.

The template's order is flax's creation order: a flax module creates
each parameter when its __call__ first reaches it, so `flax_template`
records the order in which a forward of the port's net first uses each
parameter (the port's modules are written after the flax modules, call
for call; ACT's cross attention is reordered here, `_REORDER`), groups
the leaves by module as a nested dict does, and sorts
the subtrees that JAX builds under a lifted transform. SwinIR's
template is written out from its architecture. `tests/test_torch_pth_port.py`
holds every template against JAX's key order.
"""
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.overrides import TorchFunctionMode


def flatten_dict(tree: Dict, prefix=()) -> Dict[Tuple[str, ...], object]:
    """{path tuple: leaf} of a nested dict, in its insertion order (flax's
    traverse_util.flatten_dict)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_dict(flat: Dict[Tuple[str, ...], object]) -> Dict:
    """The nested dict of {path tuple: leaf}, keys inserted in its order
    (flax's traverse_util.unflatten_dict)."""
    out: Dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _fits(t_shape: tuple, f_shape: tuple,
          kind: str = '') -> Optional[Callable]:
    """Returns the torch->flax relayout fn, or None if incompatible.

    2-D transposition takes priority over shape equality: a SQUARE
    torch Linear weight (O==I) has the same shape as the flax kernel
    but still needs the (O,I)->(I,O) transpose. Square non-layer 2-D
    tables are the rare converse; use `overrides` for those."""
    convT = lambda a: a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy()
    if kind == 'ConvTranspose2d' and len(t_shape) == 4:
        # torch convT weight is (I, O, kh, kw) and computes the conv
        # GRADIENT (kernel flipped relative to flax's fractionally-
        # strided conv): flip spatial dims on port. Kind is needed
        # because square channel counts are shape-ambiguous with Conv2d.
        i, o, kh, kw = t_shape
        return convT if f_shape == (kh, kw, i, o) else None
    if len(t_shape) == 2 and f_shape == t_shape[::-1]:   # Linear
        return lambda a: a.T
    if t_shape == f_shape:
        return lambda a: a
    if len(t_shape) == 4:
        o, i, kh, kw = t_shape
        if f_shape == (kh, kw, i, o):                    # Conv2d
            return lambda a: a.transpose(2, 3, 1, 0)
        if f_shape == (kh, kw, o, i):                    # ConvTranspose
            return convT
    if t_shape == (1,) and f_shape == ():                # PReLU slope
        return lambda a: a.reshape(())
    return None


def _cast(a: np.ndarray, like) -> np.ndarray:
    return np.asarray(a, dtype=like.dtype)


def port_state_dict(torch_params: List[Tuple[str, np.ndarray]],
                    flax_params: Dict,
                    overrides: Optional[Dict[str, str]] = None,
                    strict: bool = True) -> Dict:
    """Map an ordered [(torch_name, array)] list onto a flax-layout tree
    of identical parameter sequence. Returns the new tree (numpy).

    overrides: {torch_name: 'skip'} drops a torch entry (e.g. buffers
    the port computes at run time)."""
    overrides = overrides or {}
    tp = [t[:3] if len(t) > 2 else (t[0], t[1], '')
          for t in torch_params if overrides.get(t[0]) != 'skip']
    flat = flatten_dict(flax_params)
    keys = list(flat.keys())
    if strict and len(tp) != len(keys):
        tnames = [n for n, _, _ in tp]
        raise ValueError(
            f'param count mismatch: torch {len(tp)} vs flax '
            f'{len(keys)}\ntorch: {tnames}\nflax: '
            f'{["/".join(k) for k in keys]}')
    out = {}
    for (tname, arr, kind), fkey in zip(tp, keys):
        relayout = _fits(tuple(arr.shape), tuple(flat[fkey].shape),
                         kind)
        if relayout is None:
            raise ValueError(
                f'shape mismatch {tname} {tuple(arr.shape)} -> '
                f'{"/".join(fkey)} {tuple(flat[fkey].shape)}')
        out[fkey] = _cast(relayout(np.asarray(arr)), flat[fkey])
    return unflatten_dict(out)


def port_dsr_splines(torch_params: List[Tuple[str, np.ndarray]],
                     flax_params: Dict) -> Dict:
    """Stacked-layout port for DSR-Splines: the reference builds one
    small _SplineNet module PER knot interval
    (network_dsr_splines.py:102, `splines.{s}.model.{l}.conv.*`) while
    the flax layout runs all S branches as ONE vmapped network whose
    every kernel carries a leading (S,) axis. For each flax leaf,
    relayout the S per-spline torch tensors and stack them along the new
    leading axis."""
    arrs = {n: np.asarray(a) for n, a, *_ in torch_params}
    n_s = 1 + max(int(n.split('.')[1]) for n in arrs
                  if n.startswith('splines.'))
    # flax Conv_{i} indices follow execution order, which matches the
    # torch registration order of spline 0's conv modules — but the
    # vmap lift canonicalizes (sorts) the param dict, so match by
    # NAME, not position.
    mods = []
    for n, _a, *_k in torch_params:
        if n.startswith('splines.0.'):
            mod = n[len('splines.0.'):].rsplit('.', 1)[0]
            if mod not in mods:
                mods.append(mod)
    conv_of = {f'Conv_{i}': m for i, m in enumerate(mods)}
    leaf_of = {'kernel': 'weight', 'bias': 'bias'}
    flat = flatten_dict(flax_params)
    if len(flat) != len(mods) * 2:
        raise ValueError(
            f'param count mismatch: torch per-spline {len(mods)} convs '
            f'vs flax {len(flat)} leaves\n{mods}\n'
            f'{["/".join(k) for k in flat]}')
    out = {}
    for key in flat:
        mod = conv_of[key[-2]]
        suffix = f'{mod}.{leaf_of[key[-1]]}'
        want = tuple(flat[key].shape[1:])
        stack = []
        for s in range(n_s):
            a = arrs[f'splines.{s}.{suffix}']
            fn = _fits(tuple(a.shape), want)
            if fn is None:
                raise ValueError(
                    f'shape mismatch splines.{s}.{suffix} '
                    f'{tuple(a.shape)} -> {"/".join(key)} (S,){want}')
            stack.append(fn(a))
        out[key] = _cast(np.stack(stack), flat[key])
    return unflatten_dict(out)


def port_dbpn(torch_params: List[Tuple[str, np.ndarray]],
              flax_params: Dict, remat_blocks: bool) -> Dict:
    """Order-based DBPN port with the remat guard (see module
    docstring): the caller passes the model's `remat_blocks` setting
    explicitly so a default-config (remat=True) tree cannot be ported
    silently."""
    if remat_blocks:
        raise ValueError(
            'DBPN port requires remat_blocks=False: the remat lift '
            'sorts the param dict and DBPN\'s identically-shaped '
            'blocks would silently mis-pair under the creation-order '
            'zip (see torch_port.py module docstring).')
    return port_state_dict(torch_params, flax_params)


def torch_named_params(module) -> List[Tuple[str, np.ndarray, str]]:
    """Ordered [(name, numpy array, owner-module class name)] of a
    torch module's parameters; the kind disambiguates shape-ambiguous
    relayouts (square ConvTranspose2d vs Conv2d)."""
    kinds = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            full = f'{mname}.{pname}' if mname else pname
            kinds[full] = type(m).__name__
    return [(n, p.detach().cpu().numpy(), kinds.get(n, ''))
            for n, p in module.named_parameters()]


_SWIN_LEAF_OF = {
    'norm1.weight': 'ln1_scale', 'norm1.bias': 'ln1_bias',
    'attn.relative_position_bias_table': 'rel_pos_table',
    'attn.qkv.weight': 'qkv_kernel', 'attn.qkv.bias': 'qkv_bias',
    'attn.proj.weight': 'proj_kernel', 'attn.proj.bias': 'proj_bias',
    'norm2.weight': 'ln2_scale', 'norm2.bias': 'ln2_bias',
    'mlp.fc1.weight': 'mlp1_kernel', 'mlp.fc1.bias': 'mlp1_bias',
    'mlp.fc2.weight': 'mlp2_kernel', 'mlp.fc2.bias': 'mlp2_bias',
}
_SWIN_TORCH_OF = {v: k for k, v in _SWIN_LEAF_OF.items()}


def port_swinir(torch_params: List[Tuple[str, np.ndarray]],
                flax_params: Dict) -> Dict:
    """Name-based port of a reference SwinIR state_dict onto the
    fused-block layout (swinir_use_fused_blocks: uniform stages are
    scanned, so stage params carry a leading stage dim; the fused block
    stack stacks block params over depth).

    Reference names (network_swinir.py:710): conv_first,
    patch_embed.norm, layers.{s}.conv,
    layers.{s}.residual_group.blocks.{b}.<leaf>, norm, conv_after_body,
    conv_before_upsample.0, upsample.{2i}, conv_last."""
    tp = {t[0]: np.asarray(t[1]) for t in torch_params}
    flat = flatten_dict(flax_params)
    out = {}

    def relayout(arr, want):
        fn = _fits(tuple(arr.shape), tuple(want))
        if fn is None:
            raise ValueError((arr.shape, want))
        return fn(arr)

    def stacked(key, names_nd):
        """names_nd: nested list matching the leading stack dims."""
        want_leaf = flat[key].shape[len(np.shape(names_nd)):]

        def build(n):
            if isinstance(n, str):
                return relayout(tp.pop(n), want_leaf)
            return np.stack([build(x) for x in n])
        out[key] = _cast(build(names_nd), flat[key])

    # infer stage/depth structure from the torch names
    stages = sorted({int(m.group(1)) for n in tp
                     if (m := re.match(r'layers\.(\d+)\.', n))})
    depth = {s: 1 + max(int(m.group(1)) for n in tp
                        if (m := re.search(
                            rf'layers\.{s}\.residual_group\.blocks'
                            rf'\.(\d+)\.', n)))
             for s in stages}

    for key in flat.keys():
        ks = '/'.join(key)
        leaf = key[-1]
        wb = 'weight' if leaf in ('kernel', 'scale') else 'bias'
        if ks.startswith('conv_first/'):
            stacked(key, f'conv_first.{wb}')
        elif ks.startswith('patch_norm/'):
            stacked(key, f'patch_embed.norm.{wb}')
        elif ks.startswith('LayerNorm_0/'):
            stacked(key, f'norm.{wb}')
        elif ks.startswith('conv_after_body/'):
            stacked(key, f'conv_after_body.{wb}')
        elif ks.startswith('conv_before_up/'):
            stacked(key, f'conv_before_upsample.0.{wb}')
        elif ks.startswith('conv_last/'):
            stacked(key, f'conv_last.{wb}')
        elif ks.startswith('UpsamplerDirect_0/'):
            stacked(key, f'upsample.0.{wb}')
        elif ks.startswith('Upsampler_0/'):
            i = int(re.search(r'Conv_(\d+)', ks).group(1))
            stacked(key, f'upsample.{2 * i}.{wb}')
        elif 'blocks' in key and leaf in _SWIN_TORCH_OF:
            tleaf = _SWIN_TORCH_OF[leaf]
            if key[0] == 'stages':      # (S, d, ...) double stack
                names = [[f'layers.{s}.residual_group.blocks.{b}.'
                          f'{tleaf}' for b in range(depth[s])]
                         for s in stages]
            else:                        # rstb{s}: (d, ...) stack
                s0 = int(re.match(r'rstb(\d+)', key[0]).group(1))
                names = [f'layers.{s0}.residual_group.blocks.{b}.'
                         f'{tleaf}' for b in range(depth[s0])]
            stacked(key, names)
        elif key[0] == 'stages' and 'Conv' in ks:
            names = [f'layers.{s}.conv.{wb}' for s in stages]
            stacked(key, names)
        elif re.match(r'rstb\d+$', key[0]):
            s0 = int(re.match(r'rstb(\d+)', key[0]).group(1))
            stacked(key, f'layers.{s0}.conv.{wb}')
        else:
            raise KeyError(f'unmapped flax param {ks}')
    if tp:
        raise ValueError(f'unconsumed torch params: {sorted(tp)}')
    return unflatten_dict(out)


_GRL_PLAIN = {
    'conv_first/Conv_0': 'conv_first',
    'norm_start': 'norm_start',
    'norm_end': 'norm_end',
    'conv_after_body/Conv_0': 'conv_after_body',
    'conv_before_up/Conv_0': 'conv_before_upsample.0',
    'Upsampler_0/Conv_0/Conv_0': 'upsample.up.0',
    'conv_last/Conv_0': 'conv_last',
}
_GRL_BLOCK = {
    'CAB_0/Conv_0/Conv_0': 'conv.cab.0',
    'CAB_0/Conv_1/Conv_0': 'conv.cab.2',
    'CAB_0/Conv_2/Conv_0': 'conv.cab.3.attention.1',
    'CAB_0/Conv_3/Conv_0': 'conv.cab.3.attention.3',
    'LayerNorm_0': 'norm1',
    'LayerNorm_1': 'norm2',
    'Dense_0': 'mlp.fc1',
    'Dense_1': 'mlp.fc2',
    'MixedAttention_0/qkv': 'attn.qkv.body',
    'MixedAttention_0/anchor_proj': 'attn.anchor.body.0.reduction',
    'MixedAttention_0/proj': 'attn.proj',
    'MixedAttention_0/affine_w/cpb1':
        'attn.window_attn.attn_transform.cpb_mlp.0',
    'MixedAttention_0/affine_w/cpb2':
        'attn.window_attn.attn_transform.cpb_mlp.2',
    'MixedAttention_0/affine_w/logit_scale':
        'attn.window_attn.attn_transform.logit_scale',
    'MixedAttention_0/affine_s1/cpb1':
        'attn.stripe_attn.attn_transform1.cpb_mlp.0',
    'MixedAttention_0/affine_s1/cpb2':
        'attn.stripe_attn.attn_transform1.cpb_mlp.2',
    'MixedAttention_0/affine_s1/logit_scale':
        'attn.stripe_attn.attn_transform1.logit_scale',
    'MixedAttention_0/affine_s2/cpb1':
        'attn.stripe_attn.attn_transform2.cpb_mlp.0',
    'MixedAttention_0/affine_s2/cpb2':
        'attn.stripe_attn.attn_transform2.cpb_mlp.2',
    'MixedAttention_0/affine_s2/logit_scale':
        'attn.stripe_attn.attn_transform2.logit_scale',
}
_WB = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias',
       'logit_scale': ''}


def port_grl(torch_params: List[Tuple[str, np.ndarray]],
             flax_params: Dict) -> Dict:
    """Name-based port of a reference GRL state_dict onto the flax
    layout (blocks scanned as (no-shift, shift) pairs with a leading
    pair dim: torch layers.{s}.blocks.{b} maps to
    s{s}_blocks/GRLBlock_{b%2} at stack index b//2). Reference names:
    network_grl.py:1203 (GRL), :1008 (block), :1094 (stage convs)."""
    tp = {t[0]: np.asarray(t[1]) for t in torch_params}
    flat = flatten_dict(flax_params)
    out = {}

    def relayout(arr, want):
        fn = _fits(tuple(arr.shape), tuple(want))
        if fn is None:
            raise ValueError((arr.shape, want))
        return fn(arr)

    for key in flat.keys():
        ks = '/'.join(key)
        leaf = key[-1]
        m = re.match(r's(\d+)_blocks/GRLBlock_(\d+)/(.*)$', ks)
        if m:
            s_i, member, rest = int(m.group(1)), int(m.group(2)), \
                m.group(3)
            if leaf == 'logit_scale':
                tleaf = _GRL_BLOCK[rest]
            else:
                mod = rest.rsplit('/', 1)[0]
                tleaf = _GRL_BLOCK[mod] + '.' + _WB[leaf]
            n_pairs = flat[key].shape[0]
            arrs = []
            for p_i in range(n_pairs):
                b = p_i * 2 + member
                tname = f'layers.{s_i}.blocks.{b}.{tleaf}'
                arrs.append(relayout(tp.pop(tname),
                                     flat[key].shape[1:]))
            out[key] = _cast(np.stack(arrs), flat[key])
            continue
        m = re.match(r's(\d+)_conv/Conv_0/(kernel|bias)$', ks)
        if m:
            tname = f'layers.{m.group(1)}.conv.' + _WB[m.group(2)]
            out[key] = _cast(relayout(tp.pop(tname), flat[key].shape),
                             flat[key])
            continue
        mod = ks.rsplit('/', 1)[0]
        if mod in _GRL_PLAIN or key[0] in _GRL_PLAIN:
            base = _GRL_PLAIN.get(mod, _GRL_PLAIN.get(key[0]))
            tname = f'{base}.{_WB[leaf]}'
            out[key] = _cast(relayout(tp.pop(tname), flat[key].shape),
                             flat[key])
            continue
        raise KeyError(f'unmapped flax param {ks}')
    if tp:
        raise ValueError(f'unconsumed torch params: {sorted(tp)[:8]} '
                         f'(+{max(0, len(tp) - 8)} more)')
    return unflatten_dict(out)


# ------------------------------------------------- the flax-layout template
def _leaf(shape) -> np.ndarray:
    """A template leaf: the shape and dtype of a flax param, no data."""
    return np.broadcast_to(np.zeros((), np.float32), tuple(shape))


class _FirstUse(TorchFunctionMode):
    """Records the order in which a forward first hands each parameter
    to a torch function."""

    def __init__(self, params: Dict[int, str]):
        super().__init__()
        self.params, self.order, self.seen = params, [], set()

    def _visit(self, a):
        if isinstance(a, (list, tuple)):
            for b in a:
                self._visit(b)
        elif isinstance(a, dict):
            for b in a.values():
                self._visit(b)
        elif isinstance(a, torch.Tensor):
            name = self.params.get(id(a))
            if name is not None and name not in self.seen:
                self.seen.add(name)
                self.order.append(name)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._visit(args)
        self._visit(kwargs)
        return func(*args, **kwargs)


def first_use_order(model: nn.Module, x: torch.Tensor) -> List[str]:
    """The model's parameter names in the order an evaluation forward of
    `x` first uses them; parameters the forward leaves unused follow in
    registration order."""
    named = dict(model.named_parameters())
    rec = _FirstUse({id(p): n for n, p in named.items()})
    was = model.training
    model.eval()
    with torch.no_grad(), rec:
        model(x)
    model.train(was)
    return rec.order + [n for n in named if n not in rec.seen]


def _act_order(model: nn.Module, order: List[str]) -> List[str]:
    """ACT's CrossAttn: the flax module calls both LayerNorms before its
    Dense layers, the port's forward normalises the keys after the
    query's Dense, so LayerNorm_1 moves up behind LayerNorm_0."""
    from srcaco2_tpu_torch.models.act import CrossAttn
    for name, mod in model.named_modules():
        if isinstance(mod, CrossAttn):
            ln1 = [f'{name}.LayerNorm_1.{leaf}' for leaf in ('weight', 'bias')]
            order = [n for n in order if n not in ln1]
            at = order.index(f'{name}.LayerNorm_0.bias') + 1
            order[at:at] = ln1
    return order


# where the port's forward first uses parameters in another order than
# the flax module creates them, by net
_REORDER = {'ACT': _act_order}


# convs that JAX writes with its blocks' wrapper (an inner Conv_0) although
# the port builds them as a raw conv, by net
_WRAPPED_RAW = {'MSLapSRN': ('res1',)}


def _conv_inner(net_type: str, mod_name: str, mod) -> Optional[str]:
    """The flax level under a conv's own module: 'Conv_0' under the
    blocks' wrappers (Conv, StridedConv, a reflect-padded conv),
    'ConvTranspose_0' under ConvT, none for a raw nn.Conv. The port
    builds a wrapper's conv with the wrapper's kernel init
    (uniform_fan_in) and a raw nn.Conv with lecun_normal or the net's
    own init."""
    from srcaco2_tpu_torch.models.blocks import Conv, ConvT, uniform_fan_in
    if isinstance(mod, ConvT):
        return 'ConvTranspose_0'
    if not isinstance(mod, Conv):
        return None
    leaf = mod_name.rpartition('.')[2]
    if (mod.init is uniform_fan_in or mod.pad_mode == 'reflect'
            or re.fullmatch(r'(StridedConv|RConv)_\d+', leaf)
            or leaf in _WRAPPED_RAW.get(net_type, ())):
        return 'Conv_0'
    return None


def _flax_leaf_name(mod, leaf: str) -> str:
    from srcaco2_tpu_torch.models.blocks import Conv, ConvT, Dense
    if leaf == 'weight':
        return 'kernel' if isinstance(mod, (Conv, ConvT, Dense)) \
            else 'scale'        # LayerNorm, BatchNorm
    return leaf


def _flax_shape(mod, leaf: str, shape: tuple) -> tuple:
    from srcaco2_tpu_torch.models.blocks import Conv, ConvT
    if leaf == 'weight' and len(shape) == 4:
        if isinstance(mod, ConvT):          # (I, O, kh, kw)
            i, o, kh, kw = shape
            return (kh, kw, i, o)
        if isinstance(mod, Conv):           # (O, I, kh, kw)
            o, i, kh, kw = shape
            return (kh, kw, i, o)
    return shape


def _zoo_path(model: nn.Module, net_type: str, name: str
              ) -> Tuple[Tuple[str, ...], tuple]:
    """(flax path, flax shape) of one zoo-net parameter: the inverse of
    bridge._zoo_targets."""
    mod_name, _, leaf = name.rpartition('.')
    mod = model.get_submodule(mod_name)
    segs, out = mod_name.split('.'), []
    i = 0
    while i < len(segs):
        if segs[i] == 'convs' and out and out[-1].startswith('Upsampler_'):
            out.append(f'Conv_{segs[i + 1]}')
            i += 2
            continue
        out.append(segs[i])
        i += 1
    inner = _conv_inner(net_type, mod_name, mod)
    if inner:
        out.append(inner)
    return (tuple(out) + (_flax_leaf_name(mod, leaf),),
            _flax_shape(mod, leaf, tuple(mod.get_parameter(leaf).shape)))


def _grl_path(model, net_type, name):
    """GRL: a stage of even depth is scanned in pairs, block j of stage i
    (`s{i}_b{j}`) being pair member j % 2 at stack index j // 2 of
    `s{i}_blocks`; a stage of odd depth keeps `s{i}_b{j}`."""
    path, shape = _zoo_path(model, net_type, name)
    m = re.fullmatch(r's(\d+)_b(\d+)', path[0])
    if not m:
        return path, shape
    depth = sum(1 for n, _ in model.named_children()
                if re.fullmatch(rf's{m.group(1)}_b\d+', n))
    if depth % 2:
        return path, shape
    return ((f's{m.group(1)}_blocks', f'GRLBlock_{int(m.group(2)) % 2}')
            + path[1:], (depth // 2,) + shape)


def _dsr_path(model, net_type, name):
    """DSR-Splines: the bank's batched conv (S * O, I, kh, kw) is the
    vmapped raw nn.Conv's (S, kh, kw, I, O) kernel, `splines/Conv_<n>`,
    its bias (S * O,) the (S, O) one."""
    path, shape = _zoo_path(model, net_type, name)
    path = path[:2] + path[-1:]
    s = model.splines.n_splines
    if path[-1] == 'kernel':
        kh, kw, i, so = shape
        return path, (s, kh, kw, i, so // s)
    return path, (s, shape[0] // s)


# subtrees JAX builds under a lifted transform (nn.scan / nn.vmap), whose
# keys come back sorted
_LIFTED = {'GRL': re.compile(r's\d+_blocks'),
           'DSRSplines': re.compile(r'splines')}


def _sorted_tree(tree: Dict, lifted=None) -> Dict:
    """Sort the keys of every subtree at and below a lifted level."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if lifted is not None and lifted.fullmatch(k):
                out[k] = _sort_all(v)
            else:
                out[k] = _sorted_tree(v, lifted)
        else:
            out[k] = v
    return out


def _sort_all(tree: Dict) -> Dict:
    return {k: _sort_all(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


_SWIN_FUSED_ORDER = ('ln1_scale', 'ln1_bias', 'qkv_kernel', 'qkv_bias',
                     'rel_pos_table', 'proj_kernel', 'proj_bias',
                     'ln2_scale', 'ln2_bias', 'mlp1_kernel', 'mlp1_bias',
                     'mlp2_kernel', 'mlp2_bias')


def _swinir_template(model: nn.Module) -> Dict:
    """SwinIR's flax layout from the port model (models/swinir.py; the
    inverse of bridge._targets): conv_first, patch_norm, the stages
    (`stages/RSTB_0`, scanned with a leading stage axis when the stages
    are uniform and more than one; else `rstb{s}`), LayerNorm_0,
    conv_after_body, the upsampler and conv_last, in creation order."""
    p = dict(model.named_parameters())

    def conv(name):
        o, i, kh, kw = p[f'{name}.weight'].shape
        return {'Conv_0': {'kernel': _leaf((kh, kw, i, o)),
                           'bias': _leaf(p[f'{name}.bias'].shape)}}

    def norm(name):
        return {'scale': _leaf(p[f'{name}.weight'].shape),
                'bias': _leaf(p[f'{name}.bias'].shape)}

    def dense(name):
        return {'kernel': _leaf(p[f'{name}.weight'].shape),
                'bias': _leaf(p[f'{name}.bias'].shape)}

    def stage(s):
        st, d = model.stages[s], model.depths[s]
        out = {}
        if model.fused_blocks:
            out['blocks'] = {
                k: _leaf(p[f'stages.{s}.blocks.'
                           + k.replace('_scale', '_weight')].shape)
                for k in _SWIN_FUSED_ORDER}
        else:
            def block(b):
                pre = f'stages.{s}.blocks.{b}'
                return {'LayerNorm_0': norm(f'{pre}.norm1'),
                        'WindowAttention_0': {
                            'rel_pos_bias': _leaf(
                                p[f'{pre}.attn.rel_pos_bias'].shape),
                            'qkv': dense(f'{pre}.attn.qkv'),
                            'proj': dense(f'{pre}.attn.proj')},
                        'LayerNorm_1': norm(f'{pre}.norm2'),
                        'Dense_0': dense(f'{pre}.fc1'),
                        'Dense_1': dense(f'{pre}.fc2')}
            if d % 2 == 0:      # scanned (no-shift, shift) pairs
                out['blocks'] = _sort_all({
                    f'SwinBlock_{m}': _stack([block(2 * q + m)
                                              for q in range(d // 2)])
                    for m in (0, 1)})
            else:
                for b in range(d):
                    out[f'SwinBlock_{b}'] = block(b)
        for k in range(len(st.convs)):
            out[f'Conv_{k}'] = conv(f'stages.{s}.convs.{k}')
        return out

    tree = {'conv_first': conv('conv_first'),
            'patch_norm': norm('patch_norm')}
    n = len(model.stages)
    if (n > 1 and len(set(model.depths)) == 1
            and len(set(model.num_heads)) == 1):
        tree['stages'] = {'RSTB_0': _sort_all(_stack([stage(s)
                                                      for s in range(n)]))}
    else:
        for s in range(n):
            tree[f'rstb{s}'] = stage(s)
    tree['LayerNorm_0'] = norm('norm')
    tree['conv_after_body'] = conv('conv_after_body')
    for name, mod in model.named_children():
        if name == 'conv_before_up':
            tree['conv_before_up'] = conv('conv_before_up')
        elif name == 'upsample' and hasattr(mod, 'convs'):
            tree['Upsampler_0'] = {f'Conv_{i}': conv(f'upsample.convs.{i}')
                                   for i in range(len(mod.convs))}
        elif name == 'upsample':
            tree['UpsamplerDirect_0'] = {'Conv_0': conv('upsample.conv')}
        elif name == 'nearest':
            for i in range(len(mod)):
                tree[f'Conv_{i}'] = conv(f'nearest.{i}')
    if 'conv_last.weight' in p:
        tree['conv_last'] = conv('conv_last')
    return tree


def _stack(trees: List[Dict]) -> Dict:
    """The template of trees of one layout stacked on a new leading
    axis."""
    t0 = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else _leaf((len(trees),) + tuple(v.shape))
            for k, v in t0.items()}


def flax_template(model: nn.Module, net_type: str,
                  x: Optional[torch.Tensor] = None) -> Dict:
    """The flax-layout param tree of the port's `model` (a net of
    `net_type`, built as JAX's model.init would build it): a nested dict
    of shape-only leaves (np.broadcast_to of a zero) in flax's creation
    order. `x` is the input of the forward that records the order (the
    zoo nets; not used for SwinIR); a net whose forward first uses its
    parameters in another order than flax creates them is reordered
    here (_REORDER). tests/test_torch_pth_port.py's
    test_template_has_jax_key_order holds every net's template to JAX's
    key order."""
    from srcaco2_tpu_torch.models.swinir import SwinIR
    if isinstance(model, SwinIR):
        return _swinir_template(model)
    path_of = {'GRL': _grl_path, 'DSRSplines': _dsr_path}.get(
        net_type, _zoo_path)
    order = first_use_order(model, x)
    if net_type in _REORDER:
        order = _REORDER[net_type](model, order)
    tree: Dict = {}
    for name in order:
        path, shape = path_of(model, net_type, name)
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d.setdefault(path[-1], _leaf(shape))
    return _sorted_tree(tree, _LIFTED.get(net_type))
