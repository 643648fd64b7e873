"""Extended log-barrier (ELB) for inequality constraints f(x) <= 0 (port
of srcaco2_tpu/losses/elb.py; Kervadec et al.'s log-barrier extension).

`t` is carried in the train state and raised once per epoch by
update_t: t <- min(t * mulcoef, max_t).
"""
import torch


def elb(fx: torch.Tensor, t) -> torch.Tensor:
    """Mean extended-log-barrier penalty over the constraint values fx
    (want fx <= 0): -(1/t) log(-fx) where fx <= -1/t^2, the linear
    extension t fx - (1/t) log(1/t^2) + 1/t above."""
    fx = fx.reshape(-1)
    t = torch.as_tensor(t, dtype=fx.dtype, device=fx.device)
    ct = -1.0 / (t * t)
    safe_neg = -torch.minimum(fx, ct)            # >= 1/t^2 > 0
    log_branch = -(1.0 / t) * torch.log(safe_neg)
    lin_branch = t * fx - (1.0 / t) * torch.log(1.0 / (t * t)) + 1.0 / t
    return torch.where(fx <= ct, log_branch, lin_branch).mean()


def update_t(t: torch.Tensor, mulcoef: float, max_t: float) -> torch.Tensor:
    """The epoch's raise of the barrier's t, capped at max_t."""
    return torch.clamp(t * mulcoef, max=max_t)
