"""Composable loss: MasterLoss over elementary terms (port of
srcaco2_tpu/losses/master.py).

build_loss(args) returns a MasterLoss whose __call__ maps (outputs,
batch, params, epoch, elb_t) to (total, {name: value}). A term outside
its epoch window contributes 0 (torch.where, as the JAX package does).
Ported terms: l1, l2, neg-SSIM and ce (CSR-CNN's segmentation loss);
every other flag raises NotImplementedError (see ROADMAP.md).
"""
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from srcaco2_tpu_torch.losses import ops as L

# loss flags of the JAX package that the port does not have yet
_NOT_PORTED = ('l2sum', 'charbonnier', 'boundpred', 'local_moments',
               'img_grad', 'norm_img_grad', 'laplace', 'norm_laplace',
               'loc_var', 'norm_loc_var', 'hist', 'kde', 'w_sparsity')


@dataclass(frozen=True)
class Term:
    name: str
    lam: float
    fn: Callable     # (pred, target, ctx) -> scalar (unscaled)
    use_residuals: bool = False
    start_epoch: Optional[int] = None
    end_epoch: Optional[int] = None

    def is_on(self, epoch) -> torch.Tensor:
        epoch = torch.as_tensor(epoch)
        on = torch.ones((), dtype=torch.bool, device=epoch.device)
        if self.start_epoch is not None:
            on = on & (epoch >= self.start_epoch)
        if self.end_epoch is not None:
            on = on & (epoch <= self.end_epoch)
        return on


@dataclass
class MasterLoss:
    terms: List[Term]
    elb_init_t: float = 1.0
    elb_max_t: float = 10.0
    elb_mulcoef: float = 1.01

    @property
    def names(self) -> List[str]:
        return [t.name for t in self.terms] + ['total']

    def __call__(self, outputs: Dict, batch: Dict, params=None,
                 epoch=0, elb_t=1.0) -> Tuple[torch.Tensor, Dict]:
        pred = outputs['out']
        target = batch['h_im']
        ctx = {
            'elb_t': elb_t,
            'params': params,
            'weights': batch.get('h_per_pixel_weight'),
            'outputs': outputs,
            'batch': batch,
        }
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        holder = {}
        for t in self.terms:
            if t.use_residuals:
                if 'global_residual' not in outputs:
                    raise ValueError(f'{t.name}: model exposes no residuals')
                p = outputs['global_residual']
                y = target - outputs['x_interp']
            else:
                p, y = pred, target
            val = t.lam * t.fn(p, y, ctx)
            val = torch.where(t.is_on(torch.as_tensor(epoch,
                                                      device=pred.device)),
                              val, torch.zeros_like(val))
            holder[t.name] = val
            total = total + val
        holder['total'] = total
        return total, holder


def _weighted_mean(err, w):
    if w is None:
        return err.mean()
    return (err * w).mean()


def _l1(p, y, ctx):
    return _weighted_mean(torch.abs(p - y), ctx['weights'])


def _l2(p, y, ctx):
    return ((p - y) ** 2).mean()


def _neg_ssim(window_size):
    def f(p, y, ctx):
        return -L.ssim_train(p, y, window_size).mean()
    return f


def _log_softmax(x, dim):
    """jax.nn.log_softmax's ops in x's dtype: x - max, then minus the
    log of the exps' sum (exps rounded to the dtype, their sum taken in
    f32 and rounded, as jnp.sum does for a 16-bit input)."""
    shifted = x - x.amax(dim, keepdim=True).detach()
    s = torch.exp(shifted).float().sum(dim, keepdim=True).to(x.dtype)
    return shifted - torch.log(s)


def _ce(color_max):
    """Cross-entropy of the segmentation logits (outputs'
    raw_segmentation, (B, levels, H, W)) against the target's levels
    round(y * color_max), averaged over the pixels."""
    def f(p, y, ctx):
        logits = ctx['outputs']['raw_segmentation']
        labels = torch.round(y[:, 0] * color_max).long()
        logp = _log_softmax(logits, 1)
        return -torch.gather(logp, 1, labels[:, None]).mean()
    return f


def build_loss(args: dict) -> MasterLoss:
    """Flag-driven term construction (define_loss parity)."""
    a = args
    todo = [k for k in _NOT_PORTED if a.get(k)]
    if todo:
        raise NotImplementedError(
            f'loss terms {todo}: not ported yet (see ROADMAP.md)')

    def res(key):
        return bool(a.get(f'{key}_use_residuals', False))

    terms: List[Term] = []
    if a.get('l1'):
        terms.append(Term('l1', a['l1_lambda'], _l1, res('l1')))
    if a.get('l2'):
        terms.append(Term('l2', a['l2_lambda'], _l2, res('l2')))
    if a.get('ssim'):
        terms.append(Term('ssim', a['ssim_lambda'],
                          _neg_ssim(int(a['ssim_window_s']))))
    if a.get('ce'):
        terms.append(Term('ce', a['ce_lambda'],
                          _ce(float(a.get('color_max', 255)))))
    if not terms:
        raise ValueError('no loss term enabled (set at least one of '
                         'l1/l2/ssim/ce)')
    return MasterLoss(terms,
                      elb_init_t=float(a.get('elb_init_t', 1.0)),
                      elb_max_t=float(a.get('elb_max_t', 10.0)),
                      elb_mulcoef=float(a.get('elb_mulcoef', 1.01)))
