"""LR schedules and the optimizer chain (port of
srcaco2_tpu/train/schedule.py and the optax transforms it chains).

The chain is optax's, in its order and formulas, written as plain
functions over dicts of tensors (parameter name -> tensor):
clip_by_global_norm -> add_decayed_weights (L2 added to the gradient,
as torch-Adam's weight decay; not AdamW) -> scale_by_adam /
scale_by_amsgrad / trace (SGD momentum, optionally Nesterov) ->
scale_by_schedule(-lr). torch.optim is not used: the JAX step advances
the optimizer on a skipped step too (zero grads still go through the
chain, so the Adam moments decay and the counts move on; only the
parameters stay), which torch.optim cannot express.

Optimizer state (a dict): {'count', 'mu', 'nu'} under 'adam' (plus
'nu_max' with AMSGrad), {'trace'} under 'trace' for SGD with momentum,
and {'count'} under 'schedule'. Counts are int32 scalars.
"""
from typing import Callable, Dict, NamedTuple

import torch

from srcaco2_tpu_torch import constants

Tensors = Dict[str, torch.Tensor]
_INT32_MAX = 2 ** 31 - 1


def _pow(base: float, count: torch.Tensor) -> torch.Tensor:
    """base ** count in f32 (optax's `decay**count` on an int32 count)."""
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=count.device), count.float())


def build_schedule(tr: dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """count (int32 tensor) -> lr (f32 tensor): MultiStepLR
    (optax.piecewise_constant_schedule) or MyStepLR (single-step decay
    with a floor), times an optional linear warm-up over the first
    G_scheduler_warmup iterations."""
    base_lr = float(tr['G_optimizer_lr'])
    kind = tr['G_scheduler_type']
    gamma = float(tr['G_scheduler_gamma'])
    warm = int(tr.get('G_scheduler_warmup', 0) or 0)

    def warmup(lr, count):
        if warm <= 0:
            return lr
        return lr * torch.clamp((count + 1) / warm, max=1.0)

    if kind == constants.MYSTEPLR:
        step_size = int(tr['G_scheduler_step_size'])
        min_lr = float(tr['G_scheduler_min_lr'])

        def sched(count):
            lr = base_lr * _pow(gamma, torch.div(count, step_size,
                                                 rounding_mode='floor'))
            return warmup(torch.clamp(lr, min=min_lr), count)
        return sched
    if kind == constants.MULTISTEPLR:
        bounds = {int(m): gamma for m in tr['G_scheduler_milestones']}

        def sched(count):
            v = torch.tensor(base_lr, dtype=torch.float32,
                             device=count.device)
            for threshold, scale in sorted(bounds.items()):
                ind = torch.clamp(torch.sign(threshold - count), min=0) \
                    .float()
                v = v * ind + (1 - ind) * scale * v
            return warmup(v, count)
        return sched
    raise NotImplementedError(kind)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


def global_norm(updates: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in updates.values()))


def clip_by_global_norm(updates: Tensors, max_norm: float) -> Tensors:
    g_norm = global_norm(updates)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, (g / g_norm) * max_norm)
            for k, g in updates.items()}


def add_decayed_weights(updates: Tensors, params: Tensors,
                        wd: float) -> Tensors:
    return {k: g + wd * params[k] for k, g in updates.items()}


def _moments(updates, state, b1, b2):
    mu = {k: (1 - b1) * g + b1 * state['mu'][k] for k, g in updates.items()}
    nu = {k: (1 - b2) * (g ** 2) + b2 * state['nu'][k]
          for k, g in updates.items()}
    count = _safe_increment(state['count'])
    bc1, bc2 = 1 - _pow(b1, count), 1 - _pow(b2, count)
    mu_hat = {k: m / bc1 for k, m in mu.items()}
    nu_hat = {k: v / bc2 for k, v in nu.items()}
    return mu, nu, count, mu_hat, nu_hat


def scale_by_adam(updates: Tensors, state: dict, b1: float, b2: float,
                  eps: float):
    mu, nu, count, mu_hat, nu_hat = _moments(updates, state, b1, b2)
    out = {k: mu_hat[k] / (torch.sqrt(nu_hat[k]) + eps) for k in updates}
    return out, dict(count=count, mu=mu, nu=nu)


def scale_by_amsgrad(updates: Tensors, state: dict, b1: float, b2: float,
                     eps: float):
    mu, nu, count, mu_hat, nu_hat = _moments(updates, state, b1, b2)
    nu_max = {k: torch.maximum(state['nu_max'][k], nu_hat[k])
              for k in updates}
    out = {k: mu_hat[k] / (torch.sqrt(nu_max[k]) + eps) for k in updates}
    return out, dict(count=count, mu=mu, nu=nu, nu_max=nu_max)


def trace(updates: Tensors, state: dict, decay: float, nesterov: bool):
    new = {k: g + decay * state['trace'][k] for k, g in updates.items()}
    out = ({k: g + decay * new[k] for k, g in updates.items()}
           if nesterov else new)
    return out, dict(trace=new)


def scale_by_schedule(updates: Tensors, state: dict, step_size_fn):
    step = step_size_fn(state['count'])
    out = {k: step.to(g.dtype) * g for k, g in updates.items()}
    return out, dict(count=_safe_increment(state['count']))


class GradientTransformation(NamedTuple):
    """optax's pair: init(params) -> state; update(grads, state,
    params) -> (updates, new state). Nothing is changed in place."""
    init: Callable
    update: Callable


def build_optimizer(tr: dict) -> GradientTransformation:
    """The chain of srcaco2_tpu/train/schedule.py:build_optimizer."""
    sched = build_schedule(tr)
    clip = float(tr.get('G_optimizer_clipgrad', 0.0) or 0.0)
    wd = float(tr.get('G_optimizer_wd', 0.0) or 0.0)
    kind = tr['G_optimizer_type']
    b1, b2 = float(tr['G_optimizer_beta1']), float(tr['G_optimizer_beta2'])
    eps = float(tr['G_optimizer_eps_adam'])
    amsgrad = bool(tr.get('G_optimizer_amsgrad', False))
    mom = float(tr.get('G_optimizer_momentum', 0.0) or 0.0)
    nesterov = bool(tr.get('G_optimizer_nesterov', False))
    if kind not in (constants.ADAM, constants.SGD):
        raise NotImplementedError(kind)

    def zeros(params):
        return {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                for k, p in params.items()}

    def count0(params):
        dev = next(iter(params.values())).device
        return torch.zeros((), dtype=torch.int32, device=dev)

    def init(params: Tensors) -> dict:
        state = {}
        if kind == constants.ADAM:
            state['adam'] = dict(count=count0(params), mu=zeros(params),
                                 nu=zeros(params))
            if amsgrad:
                state['adam']['nu_max'] = zeros(params)
        elif mom > 0:
            state['trace'] = dict(trace=zeros(params))
        state['schedule'] = dict(count=count0(params))
        return state

    def update(grads: Tensors, state: dict, params: Tensors):
        u, new = dict(grads), {}
        if clip > 0:
            u = clip_by_global_norm(u, clip)
        if wd > 0:
            u = add_decayed_weights(u, params, wd)
        if kind == constants.ADAM:
            fn = scale_by_amsgrad if amsgrad else scale_by_adam
            u, new['adam'] = fn(u, state['adam'], b1, b2, eps)
        elif mom > 0:
            u, new['trace'] = trace(u, state['trace'], mom, nesterov)
        u, new['schedule'] = scale_by_schedule(
            u, state['schedule'], lambda count: -1 * sched(count))
        return u, new

    return GradientTransformation(init, update)
