"""Train state: parameters, optimizer state, EMA, ELB t (port of
srcaco2_tpu/train/state.py).

The parameters are the model's own tensors (name -> nn.Parameter), so
the step updates them in place: where JAX returns new arrays, the port
writes into the existing ones and saves a copy of every parameter.
"""
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    step: torch.Tensor                       # int32 scalar
    params: Tensors
    opt_state: dict
    ema_params: Optional[Tensors] = None     # netE when E_decay > 0
    elb_t: torch.Tensor = field(
        default_factory=lambda: torch.ones((), dtype=torch.float32))

    @classmethod
    def create(cls, params: Tensors, tx, e_decay: float = 0.0,
               elb_init_t: float = 1.0) -> 'TrainState':
        dev = next(iter(params.values())).device
        with torch.no_grad():
            ema = ({k: p.detach().clone() for k, p in params.items()}
                   if e_decay > 0 else None)
        return cls(step=torch.zeros((), dtype=torch.int32, device=dev),
                   params=params, opt_state=tx.init(params),
                   ema_params=ema,
                   elb_t=torch.tensor(elb_init_t, dtype=torch.float32,
                                      device=dev))


def ema_update(ema: Tensors, params: Tensors, decay: float) -> Tensors:
    """decay * e + (1 - decay) * p per tensor, as new tensors."""
    return {k: decay * e + (1.0 - decay) * params[k].detach()
            for k, e in ema.items()}


def all_finite(tree: Tensors) -> torch.Tensor:
    """One bool scalar: every floating tensor is finite."""
    dev = next(iter(tree.values())).device
    out = torch.ones((), dtype=torch.bool, device=dev)
    for x in tree.values():
        if x.is_floating_point():
            out = out & torch.isfinite(x).all()
    return out
