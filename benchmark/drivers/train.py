"""The training driver: the program's train step over batches drawn from
the seed, for `--seconds` seconds, and the check of its first steps
against the plain reference.

Set-up builds one training step (the program's model, optimizer state
and `train/steps.py:make_train_step`) with weights drawn from the seed,
and drives it through its first `checked_steps` steps, which also warm up
every shape. The window then goes on with the same step object. After
the window the reference repeats the first steps from the same weights,
images and draws, in float32, and the run compares per step the loss,
the first gradient as the optimizer took it (from its first moment) and
each leaf's change over the checked steps.
"""
import math
import statistics
import time

import torch
import torch.nn.functional as F

from benchmark import core
from benchmark.reference import common as RC


def make_stacks(cell, seed: int, device):
    """The uint8 image stacks, NHWC: `images` HR images of hr_side^2
    drawn uniformly, and their LR images, the HR images' means over
    scale x scale blocks rounded to uint8."""
    tr, cfg = cell.traffic, cell.cfg
    gen = torch.Generator(device=device).manual_seed(
        core.sub_seed(seed, 'images'))
    n, side, c = tr['images'], tr['hr_side'], cfg['in_chans']
    hr = torch.randint(0, 256, (n, side, side, c), generator=gen,
                       device=device, dtype=torch.uint8)
    lr = F.avg_pool2d(hr.permute(0, 3, 1, 2).float(), cfg['scale'])
    lr = lr.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return hr, lr


class Draws:
    """The batches' image indices, HR patch origins (row, column) and
    dihedral modes, one batch at a time from the seed's stream."""

    def __init__(self, cell, seed: int, device):
        tr = cell.traffic
        self.batch, self.n = tr['batch'], tr['images']
        self.hi = tr['hr_side'] - tr['h_size'] + 1
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(
            core.sub_seed(seed, 'draws'))

    def next(self):
        g, b, d = self.gen, self.batch, self.device
        idxs = torch.randint(0, self.n, (b,), generator=g, device=d)
        x0 = torch.randint(0, self.hi, (b,), generator=g, device=d)
        y0 = torch.randint(0, self.hi, (b,), generator=g, device=d)
        mode = torch.randint(0, 8, (b,), generator=g, device=d)
        return idxs, x0, y0, mode


def weights(cell, seed: int, device) -> dict:
    """The configuration's parameters, in the reference's layout, drawn
    on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        core.sub_seed(seed, 'weights'))
    return cell.reference().init_params(cell.cfg, gen, device)


def leaf_norms(tree: dict) -> dict:
    names = list(tree)
    vals = torch.stack([tree[k].detach().float().norm() for k in names])
    return dict(zip(names, vals.tolist()))


class Program:
    """The program's training step for the cell: its model, loss,
    optimizer chain and batch pipeline, built once."""

    def __init__(self, cell, device):
        from srcaco2_tpu_torch.config.defaults import get_config
        from srcaco2_tpu_torch.data import pipeline as P
        from srcaco2_tpu_torch.losses.master import build_loss
        from srcaco2_tpu_torch.models.registry import define_g
        from srcaco2_tpu_torch.train.schedule import build_optimizer
        cfg, tr = cell.cfg, cell.traffic
        self.port, self.cfg, self.P = cell.port(), cfg, P
        self.model = define_g(self.port.port_args(cfg, tr['h_size']),
                              device).train()
        loss, opt = cfg['train']['loss'], cfg['train']['optimizer']
        args = get_config()
        args.update(l2=True, l2_lambda=loss['l2_lambda'], ssim=True,
                    ssim_lambda=loss['ssim_lambda'],
                    ssim_window_s=loss['ssim_window'])
        args['train'].update(
            G_optimizer_type='adam', G_optimizer_lr=opt['lr'],
            G_optimizer_wd=opt['weight_decay'],
            G_optimizer_beta1=opt['beta1'], G_optimizer_beta2=opt['beta2'],
            G_optimizer_eps_adam=opt['eps'], G_optimizer_clipgrad=0.0,
            G_optimizer_amsgrad=False)
        self.master = build_loss(args)
        self.tx = build_optimizer(args['train'])
        self.pipe = P.PipeConfig(scale=cfg['scale'], h_size=tr['h_size'],
                                 n_channels=cfg['in_chans'])
        # the network's output in the step, read while `capture` is set
        self.capture, self.captured = False, None
        self.model.register_forward_hook(self._keep_output)

    def _keep_output(self, module, args, out):
        if self.capture:
            out = out['out'] if isinstance(out, dict) else out
            self.captured = out.detach().float().cpu()

    def start(self, ref_params: dict):
        """A fresh train state on the given weights, and its step."""
        from srcaco2_tpu_torch.train.state import TrainState
        from srcaco2_tpu_torch.train.steps import make_train_step
        with torch.no_grad():
            self.model.load_state_dict(self.port.to_port(ref_params,
                                                         self.cfg))
        self.state = TrainState.create(dict(self.model.named_parameters()),
                                       self.tx)
        self.step_fn = make_train_step(self.model, self.master, self.tx,
                                       self.port.net_type(self.cfg),
                                       self.pipe)

    def step(self, hr, lr, batch):
        idxs, x0, y0, mode = batch
        self.state, holder, ok = self.step_fn(self.state, hr, lr, idxs,
                                              self.P.Draws(x0, y0, mode))
        return holder, ok

    def first_moment(self) -> dict:
        return self.state.opt_state['adam']['mu']


def program_readings(prog: Program, hr, lr, draws: Draws, n: int,
                     beta1: float) -> dict:
    """Drive the program's step through its first n steps and read the
    loss of each, the first step's gradient (from the optimizer's first
    moment) and each leaf's change over the n steps, by the reference's
    leaves."""
    port, cfg = prog.port, prog.cfg
    p0 = {k: v.detach().clone() for k, v in prog.state.params.items()}
    losses, oks, grad = [], [], None
    for i in range(n):
        prog.capture = i == 0
        holder, ok = prog.step(hr, lr, draws.next())
        prog.capture = False
        losses.append(holder['total'])
        oks.append(ok)
        if i == 0:
            grad = leaf_norms(port.from_port(
                {k: m / (1 - beta1) for k, m in
                 prog.first_moment().items()}, cfg))
    delta = {k: v.detach() - p0[k] for k, v in prog.state.params.items()}
    return dict(loss=[float(x) for x in losses],
                ok=[bool(o) for o in oks], grad=grad, pred=prog.captured,
                change=leaf_norms(port.from_port(delta, cfg)))


def reference_readings(cell, seed: int, device, precision: str = 'f32',
                       rows: float = 1.0) -> dict:
    """The plain reference's first steps from the same weights, images
    and draws, in `precision`. With rows < 1 (a fault of the check's own
    test) the network runs on every row of each batch, but the loss is
    the mean over only that share of its rows."""
    cfg, tr = cell.cfg, cell.traffic
    ref = cell.reference()
    loss_cfg, opt = cfg['train']['loss'], cfg['train']['optimizer']
    pr = RC.Precision(precision)
    params = weights(cell, seed, device)
    p0 = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    hr, lr = make_stacks(cell, seed, device)
    draws = Draws(cell, seed, device)
    st = RC.adam_init(params)
    block = int(tr['reference_rows'])
    losses, parts, grad, raw, pred1 = [], [], None, None, None
    with RC.true_f32():
        for i in range(int(tr['checked_steps'])):
            x, y = RC.train_batch(hr, lr, *draws.next(), cfg['scale'],
                                  tr['h_size'])
            keep = max(1, int(round(tr['batch'] * rows)))
            grads = {k: torch.zeros_like(v) for k, v in params.items()}
            l2 = ssim = 0.0
            preds = []
            for s in range(0, tr['batch'], block):
                pred = ref.forward(params, x[s:s + block], cfg, pr)
                if i == 0:
                    preds.append(pred.detach().float().cpu())
                m = min(block, keep - s)
                if m <= 0:
                    continue
                a, b = RC.loss_part(pred[:m], y[s:s + m], loss_cfg, keep)
                gs = torch.autograd.grad(a + b, list(params.values()))
                for k, gk in zip(params, gs):
                    grads[k] += gk
                l2, ssim = l2 + a.detach(), ssim + b.detach()
                del pred, gs
            total = float(l2 + ssim)
            with torch.no_grad():
                RC.adam_update(params, grads, st, opt,
                               ok=math.isfinite(total))
            if i == 0:
                pred1 = torch.cat(preds)
                grad = leaf_norms(RC.first_grad(st, opt))
                raw = leaf_norms(grads)
            losses.append(total)
            parts.append(abs(float(l2)) + abs(float(ssim)))
    change = leaf_norms({k: params[k].detach() - p0[k] for k in params})
    return dict(loss=losses, loss_scale=parts, grad=grad, raw_grad=raw,
                change=change, pred=pred1)


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


def compare(prog: dict, ref: dict, skip_share: float = 1e-3) -> dict:
    """The numbers of the check (a cell's limits name those it holds):
    `loss_gap`, the worst step's loss gap over the size of the
    reference's loss terms; `pred1_gap`, the root mean square gap of the
    network's output in the first step over the reference output's
    standard deviation (inf where the outputs' shapes differ);
    `grad_gap`, the worst leaf's gap of first-gradient norms over the
    larger of that leaf's reference norm and the median leaf's;
    `change_gap`, the same of each leaf's change over the checked steps,
    leaving out the leaves whose reference gradient (weight decay not
    added) is under `skip_share` of the median leaf's: they move by
    rounding alone."""
    loss_gap = max(abs(p - r) / s for p, r, s in
                   zip(prog['loss'], ref['loss'], ref['loss_scale']))
    p, r = prog['pred'], ref['pred']
    pred1 = (float((p - r).pow(2).mean().sqrt() / r.std())
             if p is not None and p.shape == r.shape else math.inf)
    raw_med = statistics.median(ref['raw_grad'].values())
    moved = [k for k, g in ref['raw_grad'].items()
             if g >= skip_share * raw_med]
    return dict(loss_gap=loss_gap, pred1_gap=pred1,
                grad_gap=max(_leaf_gaps(prog['grad'], ref['grad'],
                                        list(ref['grad']))),
                change_gap=max(_leaf_gaps(prog['change'], ref['change'],
                                          moved)),
                leaves=len(ref['grad']),
                leaves_left_out=len(ref['grad']) - len(moved))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _steps(prog, hr, lr, draws, keep_going):
    """Steps while keep_going(steps so far); returns (steps, failed
    steps as a device tensor)."""
    bad = torch.zeros((), dtype=torch.int32, device=hr.device)
    steps = 0
    while keep_going(steps):
        with core.span('draws'):
            batch = draws.next()
        with core.span('step'):
            _, ok = prog.step(hr, lr, batch)
        bad += (~ok).int()
        steps += 1
    return steps, bad


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    """One run of a training cell; see the module's docstring."""
    from srcaco2_tpu_torch.ops.build import build_all
    tr, cfg = cell.traffic, cell.cfg
    mark = core.Marks(t_start)
    mark('imports')
    if device.type == 'cuda':
        build_all()
    mark('build')
    prog = Program(cell, device)
    prog.start(weights(cell, seed, device))
    mark('model')
    hr, lr = make_stacks(cell, seed, device)
    draws = Draws(cell, seed, device)
    mark('data')
    beta1 = float(cfg['train']['optimizer']['beta1'])
    readings = program_readings(prog, hr, lr, draws,
                                int(tr['checked_steps']), beta1)
    _sync(device)
    mark('checked_steps')
    cuda = device.type == 'cuda'
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, bad = _steps(prog, hr, lr, draws,
                        lambda n: time.perf_counter() - t0 < seconds)
    _sync(device)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = int(bad) + sum(not o for o in readings['ok'])
    out = dict(setup_s=setup_s, window_s=window_s,
               attempted=steps + len(readings['ok']), failed=failed,
               memory_peak_bytes=max(setup_peak, window_peak),
               e2e=dict(setup_s=setup_s,
                        patches_per_s=steps * tr['batch'] / window_s),
               obs=dict(cfg=cfg, traffic=tr, window_peak_bytes=window_peak))
    if trace:
        # the device alone over trace_steps steps, then one step with the
        # host's ops, whose idle gaps say what the host was doing
        with core.Traced(device) as traced:
            t1 = time.perf_counter()
            n_tr, bad_tr = _steps(prog, hr, lr, draws,
                                  lambda n: n < int(tr['trace_steps']))
            _sync(device)
            traced_s = time.perf_counter() - t1
        with core.Traced(device, host=True) as hosted:
            n_h, bad_h = _steps(prog, hr, lr, draws, lambda n: n < 1)
        out['failed'] += int(bad_tr) + int(bad_h)
        out['attempted'] += n_tr + n_h
        out['obs'].update(traced=traced.summary, traced_s=traced_s,
                          traced_samples=n_tr * tr['batch'],
                          host_gaps=hosted.summary['idle_gaps'])
    del prog, hr, lr, draws
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, device)
    numbers = compare(readings, ref)
    out['checks'] = {k: numbers[k] for k in cell.limits}
    out['notes'] = dict(setup_phases=mark.phases, steps=steps,
                        leaves=numbers['leaves'],
                        leaves_left_out=numbers['leaves_left_out'],
                        loss=readings['loss'], ref_loss=ref['loss'])
    return out
