"""The train step and the full-image eval forward (port of
srcaco2_tpu/train/steps.py:make_train_step and make_eval_forward).

One step: assemble the batch on the device from its draws, forward the
model in training mode, the loss, the grads, the non-finite skip (a
skipped step still passes zero grads through the optimizer chain, so the
moments decay and the counts advance; only the parameters stay), the
EMA, and the skip / corruption flags. JAX jits the step with donated
state; the port runs it eagerly and updates the parameters and the EMA
in place.

Under data parallelism (`grid`, parallel/mesh.py) each rank takes its
rows of the global batch and draws; the grads are averaged over the
ranks between the backward and the finite check, and the loss holder
with them, so that every rank skips, updates and flags alike.

On the card the checks, the chain, the masked update and the EMA run as
one multi-tensor pass (ops/fused_update.py), which equals the eager
chain; the eager chain runs where the parameters are on the CPU.

Each phase is a span of utils/profiling, recorded only while a profiler
records: `train.step` (one update), and inside it `train.assemble`,
`train.forward` (the model and the loss), `train.backward`,
`train.checks` (twice: the finite check of the loss and grads with the
mask it drives, and the corruption check of the new parameters) and
`train.optimizer` (the optimizer chain, the masked update and the EMA).
The counter `train.update_fused` counts the steps that take the pass.
"""
from typing import Callable

import torch

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.losses.master import MasterLoss
from srcaco2_tpu_torch.ops import fused_update
from srcaco2_tpu_torch.ops.resize import resize2d
from srcaco2_tpu_torch.parallel import mesh
from srcaco2_tpu_torch.train.state import TrainState, all_finite, ema_update
from srcaco2_tpu_torch.utils.profiling import count, span


def model_outputs(raw) -> dict:
    """A model's return as the JAX nets' outputs dict ('out', and
    'x_interp' / 'global_residual' / 'intermediate_outs' where the net
    has them): the zoo's dicts as they are, SwinIR's tensor under
    'out'."""
    return raw if isinstance(raw, dict) else {'out': raw}


def pre_upsampled(net_type: str, netG: dict = None) -> bool:
    """Whether the net takes the bicubic pre-upscale of the LR image
    (SRCNN, and CSR-CNN but its pyramid variant) rather than the LR
    image: the one rule of training, evaluation and serving."""
    if net_type in constants.PRE_UPSAMPLED_INPUT_NETS:
        return True
    return (net_type == constants.CSRCNN
            and (netG or {}).get('csrcnn_net_type', constants.NET_TYPE_UNET)
            != constants.NET_TYPE_PYRAMID)


def net_input(net_type: str, batch: dict, netG: dict = None) -> torch.Tensor:
    """The pre-upscale for a pre-upsampling net (pre_upsampled), else the
    LR patch."""
    return batch['l_to_h_img' if pre_upsampled(net_type, netG) else 'l_im']


def compute_model_loss(net_type: str, master: MasterLoss, outputs: dict,
                       batch: dict, params, epoch, elb_t):
    """The per-net loss dispatch of the JAX package: a curriculum net
    (SRFBN) supervises every step's output against the full target,
    averaged over the steps; a progressive net (MSLapSRN, ProSR) adds to
    the final loss each level's loss against the target resized to the
    level (bicubic, align_corners, clipped to [0, 1]; the per-pixel
    weights dropped), averaged over the levels + 1. A net without
    intermediate outputs takes the master loss as it is. The holder's
    terms are averaged as the total is."""
    inter = outputs.get('intermediate_outs')
    if inter is None:
        return master(outputs, batch, params, epoch, elb_t)
    if net_type == constants.SRFBN:
        parts = [master({**outputs, 'out': o}, batch, params, epoch, elb_t)
                 for o in inter]
    elif net_type in (constants.MSLAPSR, constants.PROSR):
        parts = [master(outputs, batch, params, epoch, elb_t)]
        level_batch = {k: v for k, v in batch.items()
                       if k != 'h_per_pixel_weight'}
        for o in inter:
            target = torch.clip(resize2d(batch['h_im'], o.shape[-2:],
                                         align_corners=True), 0.0, 1.0)
            parts.append(master({**outputs, 'out': o},
                                {**level_batch, 'h_im': target}, params,
                                epoch, elb_t))
    else:
        return master(outputs, batch, params, epoch, elb_t)
    total = torch.zeros((), dtype=torch.float32,
                        device=outputs['out'].device)
    holder = None
    for t_i, h_i in parts:
        total = total + t_i
        holder = h_i if holder is None else \
            {k: holder[k] + h_i[k] for k in holder}
    n = float(len(parts))
    return total / n, {k: v / n for k, v in holder.items()}


def loss_and_grads(model, master: MasterLoss, net_type: str, params: dict,
                   batch: dict, epoch, elb_t, netG: dict = None,
                   lsh: torch.Generator = None):
    """(loss, holder, prediction, {name: grad}) of one forward and
    backward in training mode; a parameter the loss does not reach gets
    a zero grad. The forward updates the model's BatchNorm statistics
    (MemNet) in place, as JAX's mutable batch_stats, on a skipped step
    too. `lsh` is the generator of the forward's hash rotations (NLSN's
    lsh_generator; JAX's 'lsh' rng stream)."""
    model.train()
    x = net_input(net_type, batch, netG)
    with span('train.forward'):
        if hasattr(model, 'lsh_generator'):
            model.lsh_generator = lsh
        try:
            outputs = model_outputs(model(x))
        finally:
            if hasattr(model, 'lsh_generator'):
                model.lsh_generator = None
        total, holder = compute_model_loss(net_type, master, outputs, batch,
                                           params, epoch, elb_t)
    names = list(params)
    with span('train.backward'):
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
    return total.detach(), holder, outputs['out'].detach(), grads


def _eager_update(tx, state: TrainState, safe, ok, e_decay: float):
    """The eager chain over the masked grads, the masked update of the
    parameters and the EMA, one leaf at a time (the CPU path)."""
    updates, state.opt_state = tx.update(safe, state.opt_state,
                                         state.params)
    for k, p in state.params.items():
        p.copy_(torch.where(ok, p + updates[k], p))
    if e_decay > 0 and state.ema_params is not None:
        new_ema = ema_update(state.ema_params, state.params, e_decay)
        for k, e in state.ema_params.items():
            e.copy_(new_ema[k])


def make_train_step(model, master: MasterLoss, tx, net_type: str,
                    pipe_cfg: P.PipeConfig, e_decay: float = 0.0,
                    steps_per_epoch: int = 1,
                    ppiw_table: torch.Tensor = None,
                    netG: dict = None,
                    steps_per_call: int = 1, grid=None) -> Callable:
    """The train step: (state, hr_u8, lr_u8, idxs, draws) -> (state,
    loss holder, ok flag), where draws = pipeline.draw(gen, ...) are the
    batch's patch origins, dihedral modes and local-aug choices (JAX
    derives them from a key inside the step) and, in draws.lsh, the
    generator of the step's hash rotations (NLSN). ppiw_table (256,) on
    the stacks' device gives the batch its per-pixel weights
    (h_per_pixel_weight) when pipe_cfg.ppiw is on. state.params must be
    the model's parameters;
    the step updates them, the optimizer state and the EMA in place.

    steps_per_call = K > 1, the superstep (JAX: a lax.scan over K steps
    in one jitted call): idxs is (K, B), draws a sequence of K Draws, and
    K updates run one after the other with no host read between them;
    the holder's entries are the K steps' values stacked (K,), and ok is
    one flag for all K. Each update is the one-step function, so K steps
    in one call equal K calls of one step bit for bit. The caller picks
    the chunk's K (the trainer never lets a call cross an epoch, eval or
    save boundary), so idxs may hold fewer than steps_per_call rows.

    grid (parallel/mesh.Grid): the step of one rank of a data-parallel
    job. idxs and draws stay the global batch's; the rank takes its rows
    (mesh.shard_train_step), its BatchNorms take the global statistics,
    l2sum is scaled by the data shards, and one all-reduce of the grads
    and one of the holder (with the prediction's finite flag) come
    before the finite check, once per update (the superstep too)."""
    if grid is not None:
        mesh.sync_batch_norm(model, grid)
        master.sum_scale = float(grid.data)
    fused = fused_update.FusedUpdate(tx.options, e_decay)

    def step_fn(state: TrainState, hr_u8, lr_u8, idxs, draws):
        with span('train.step'):
            epoch = torch.div(state.step, steps_per_epoch,
                              rounding_mode='floor')
            with span('train.assemble'):
                batch = P.assemble(hr_u8, lr_u8, idxs, draws, pipe_cfg,
                                   ppiw_table)
            loss, holder, pred, grads = loss_and_grads(
                model, master, net_type, state.params, batch, epoch,
                state.elb_t, netG, lsh=draws.lsh)
            with torch.no_grad():
                pred_bad = ~torch.isfinite(pred).all()
                if grid is not None:
                    grads = grid.all_reduce_grads(grads)
                    names = list(holder)
                    vals = grid.all_reduce_sum(torch.stack(
                        [holder[k].detach().float() for k in names]
                        + [pred_bad.float()]))
                    holder = {k: vals[i] / grid.world
                              for i, k in enumerate(names)}
                    loss, pred_bad = holder['total'], vals[-1] > 0
                # non-finite loss or grads -> skip the update
                with span('train.checks'):
                    flags = fused.begin(loss, grads, state)
                    if flags is None:
                        ok = torch.isfinite(loss) & all_finite(grads)
                        safe = {k: torch.where(ok, g, torch.zeros_like(g))
                                for k, g in grads.items()}
                    else:
                        ok, bad = flags
                with span('train.optimizer'):
                    if flags is None:
                        _eager_update(tx, state, safe, ok, e_decay)
                    else:
                        fused.apply()
                        count('train.update_fused')
                with span('train.checks'):
                    if flags is None:
                        bad = ~all_finite(state.params)
                    corrupt = bad | pred_bad
                holder = {k: v.detach() for k, v in holder.items()}
                holder['_skipped'] = (~ok).float()
                holder['_corrupt'] = corrupt.float()
                holder['_flags'] = (holder['_skipped']
                                    + 2.0 * holder['_corrupt'])
                state.step = state.step + 1
            return state, holder, ok & ~corrupt

    if grid is not None:
        step_fn = mesh.shard_train_step(step_fn, grid)
    if steps_per_call <= 1:
        return step_fn

    def multi_fn(state: TrainState, hr_u8, lr_u8, idxs_k, draws_k):
        if idxs_k.shape[0] != len(draws_k):
            raise ValueError(f'{idxs_k.shape[0]} index rows, '
                             f'{len(draws_k)} draws')
        holders, oks = [], []
        for idxs, draws in zip(idxs_k, draws_k):
            state, holder, ok = step_fn(state, hr_u8, lr_u8, idxs, draws)
            holders.append(holder)
            oks.append(ok)
        stacked = {k: torch.stack([h[k] for h in holders])
                   for k in holders[0]}
        return state, stacked, torch.stack(oks).all()

    return multi_fn


def make_eval_forward(model, net_type: str, scale: int, netG: dict = None,
                      test_mode: int = 0) -> Callable:
    """Full-image forward: (params, batch) -> the uint8-rounded
    prediction in [0, 255] NCHW (f32), run in evaluation mode under
    torch.inference_mode(). `params` is None for the model's own
    parameters, or a {name: tensor} dict (the EMA weights, say) run
    through the model by torch.func.functional_call. Window-padded
    models pad inside their forward. test_mode != 0 wraps the forward in
    the tiled / x8 inference modes (train/test_modes.py). JAX's unused
    `use_ema` is left out: the caller picks the weights it passes."""
    from srcaco2_tpu_torch.ops.metrics import uint8_round
    from srcaco2_tpu_torch.train import test_modes as TM

    @torch.inference_mode()
    def fwd(params, batch):
        model.eval()
        x = net_input(net_type, batch, netG)

        def raw(z):
            if params is None:
                return model_outputs(model(z))['out']
            return model_outputs(torch.func.functional_call(
                model, params, (z,)))['out']

        return uint8_round(TM.test_mode(raw, x, mode=test_mode, sf=scale)
                           if test_mode else raw(x))

    return fwd
