"""Composable loss: MasterLoss over elementary terms (port of
srcaco2_tpu/losses/master.py).

build_loss(args) returns a MasterLoss whose __call__ maps (outputs,
batch, params, epoch, elb_t) to (total, {name: value}). A term outside
its epoch window contributes 0 (torch.where, as the JAX package does).
The terms: l1 (with the per-pixel weights of ppiw), l2, l2sum, neg-SSIM,
charbonnier, boundpred (ELB), local_moments, the derivative terms
(img_grad, laplace, loc_var and their norm_ forms), hist, kde, ce
(CSR-CNN's segmentation loss) and w_sparsity (the sum of |w| over the
params: the nn.Parameters, as JAX's param tree, never the buffers).

Two behaviours of the JAX terms are kept: a norm_ term's vector norm
has a NaN gradient wherever a whole derivative vector of the prediction
is zero (jnp.linalg.norm's, so the step is skipped), and the
convolution terms refuse a bf16 prediction (ops.py).
"""
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.losses import ops as L
from srcaco2_tpu_torch.losses.elb import elb


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


def _l2sum(p, y, ctx):
    return ((p - y) ** 2).sum()


def _charbonnier(eps):
    def f(p, y, ctx):
        d = y - p
        return torch.sqrt(d * d + eps).mean()
    return f


def _neg_ssim(window_size):
    def f(p, y, ctx):
        return -L.ssim_train(p, y, window_size).mean()
    return f


def _boundpred(eps, restore_range, color_max):
    """ELB penalty keeping each predicted pixel within eps of its target
    (in the color range with restore_range)."""
    def f(p, y, ctx):
        b = p.shape[0]
        yh = p.reshape(b, -1)
        yy = y.reshape(b, -1)
        if restore_range:
            yh = yh * color_max
            yy = yy * color_max
        right = yh - (yy + eps)
        left = yy - eps - yh
        t = ctx['elb_t']
        return (elb(right, t) + elb(left, t)) / 2.0
    return f


def _local_moments(kszs):
    """KL between the local Gaussians of target and prediction for each
    window size, on the pixels where the target's variance at the
    smallest size is 0."""
    def f(p, y, ctx):
        loss = 0.0
        filter_smooth = None
        for i, k in enumerate(kszs):
            sm, sv = L.patch_moments(p, k)
            tm, tv = L.patch_moments(y, k)
            if i == 0:
                filter_smooth = (tv == 0).float()
            kl = L.kl_2_gaussians(sm, sv, tm, tv)
            loss = loss + (kl * filter_smooth).mean()
        return loss
    return f


def _vector_norm(x):
    """jnp.linalg.norm(x, axis=1, keepdims=True): sqrt of the sum of
    squares, whose gradient is NaN at a zero vector (torch.linalg.norm
    gives 0 there)."""
    return torch.sqrt((x * x).sum(1, keepdim=True))


def _deriv_loss(op, norm_str, norm_of_vec=False):
    def f(p, y, ctx):
        trg = op(y).detach()
        prd = op(p)
        if norm_of_vec:
            trg = _vector_norm(trg)
            prd = _vector_norm(prd)
        d = prd - trg
        if norm_str == constants.NORM1:
            return torch.abs(d).mean()
        return (d * d).mean()
    return f


def _hist(norm_str, sigma, nbins):
    def f(p, y, ctx):
        b = p.shape[0]
        trg = L.soft_histogram(y.reshape(b, -1), nbins, 0.0, 1.0,
                               sigma).detach()
        trg = trg + 1.0
        trg = trg / trg.sum(-1, keepdim=True)
        prd = L.soft_histogram(p.reshape(b, -1), nbins, 0.0, 1.0, sigma)
        prd = prd + 1.0
        prd = prd / prd.sum(-1, keepdim=True)
        if norm_str == constants.KL:
            return (trg * (torch.log(trg) - torch.log(prd))).sum(-1).mean()
        if norm_str == constants.BH:
            return elb(-L.bhattacharyya(prd, trg), ctx['elb_t'])
        if norm_str == constants.NORM1:
            return torch.abs(prd - trg).mean()
        return ((prd - trg) ** 2).mean()
    return f


def _kde(norm_str, bw, nbins):
    def f(p, y, ctx):
        eps = 1e-4
        trg = L.gaussian_kde(y, nbins, bw).detach() + eps
        prd = L.gaussian_kde(p, nbins, bw) + eps
        if norm_str == constants.BH:
            return elb(-L.bhattacharyya(prd, trg), ctx['elb_t'])
        if norm_str == constants.NORM1:
            return torch.abs(prd - trg).mean() / prd.shape[1]
        return ((prd - trg) ** 2).mean() / prd.shape[1]
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


def _w_sparsity(p, y, ctx):
    """Sum of |w| over the params, leaf by leaf."""
    total = torch.zeros((), dtype=torch.float32, device=p.device)
    for w in ctx['params'].values():
        total = total + torch.abs(w).sum()
    return total


def build_loss(args: dict) -> MasterLoss:
    """Flag-driven term construction (define_loss parity)."""
    a = args

    def res(key):
        return bool(a.get(f'{key}_use_residuals', False))

    terms: List[Term] = []
    if a.get('l1'):
        terms.append(Term('l1', a['l1_lambda'], _l1, res('l1')))
    if a.get('l2'):
        terms.append(Term('l2', a['l2_lambda'], _l2, res('l2')))
    if a.get('l2sum'):
        terms.append(Term('l2sum', a['l2sum_lambda'], _l2sum,
                          res('l2sum')))
    if a.get('ssim'):
        terms.append(Term('ssim', a['ssim_lambda'],
                          _neg_ssim(int(a['ssim_window_s']))))
    if a.get('charbonnier'):
        terms.append(Term('charbonnier', a['charbonnier_lambda'],
                          _charbonnier(a['charbonnier_eps']),
                          res('charbonnier')))
    if a.get('boundpred'):
        terms.append(Term('boundpred', a['boundpred_lambda'],
                          _boundpred(a['boundpred_eps'],
                                     a['boundpred_restore_range'],
                                     float(a.get('color_max', 255))),
                          res('boundpred')))
    if a.get('local_moments'):
        kszs = sorted(int(k) for k in
                      str(a['local_moments_ksz']).split('_'))
        terms.append(Term('local_moments', a['local_moments_lambda'],
                          _local_moments(kszs), res('local_moments')))
    for name, op, norm_key, of_vec in (
            ('img_grad', L.image_gradient, 'img_grad_norm', False),
            ('norm_img_grad', L.image_gradient, 'norm_img_grad_type', True),
            ('laplace', L.laplacian_filter, 'laplace_norm', False),
            ('norm_laplace', L.laplacian_filter, 'norm_laplace_type', True),
            ('loc_var', L.local_variation, 'loc_var_norm', False),
            ('norm_loc_var', L.local_variation, 'norm_loc_var_type', True)):
        if a.get(name):
            if op is L.local_variation:
                op = functools.partial(op, ksz=int(a[f'{name}_ksz']))
            terms.append(Term(name, a[f'{name}_lambda'],
                              _deriv_loss(op, a[norm_key], of_vec),
                              res(name)))
    if a.get('hist'):
        nbins = int(a.get('color_max', 255)) - int(a.get('color_min', 0)) \
            + 1
        terms.append(Term('hist', a['hist_lambda'],
                          _hist(a['hist_metric'], float(a['hist_sigma']),
                                nbins)))
    if a.get('kde'):
        terms.append(Term('kde', a['kde_lambda'],
                          _kde(a['kde_metric'], float(a['kde_kde_bw']),
                               int(a['kde_nbins']))))
    if a.get('ce'):
        terms.append(Term('ce', a['ce_lambda'],
                          _ce(float(a.get('color_max', 255)))))
    if a.get('w_sparsity'):
        terms.append(Term('w_sparsity', a['w_sparsity_lambda'],
                          _w_sparsity))
    if not terms:
        raise ValueError('no loss term enabled (set at least one of '
                         'l1/l2/...)')
    return MasterLoss(terms,
                      elb_init_t=float(a.get('elb_init_t', 1.0)),
                      elb_max_t=float(a.get('elb_max_t', 10.0)),
                      elb_mulcoef=float(a.get('elb_mulcoef', 1.01)))
