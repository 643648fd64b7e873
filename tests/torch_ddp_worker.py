"""Ranks of the port's data-parallel tests (tests/test_torch_ddp_*.py):
torch.multiprocessing processes over gloo on the CPU, joined through a
file:// store under the test's tmp_path (no TCP port to collide under
pytest-xdist), with a process-group timeout of at most 60 s. Each rank
runs a module-level function of this file (spawned processes import it
by name; it imports no jax, so a rank starts in ~2 s) and writes its
result with torch.save; `spawn` joins every rank with a timeout and
kills what is left."""
import os
import sys
import time
import traceback

import torch

from srcaco2_tpu_torch.losses.master import build_loss
from srcaco2_tpu_torch.train.schedule import build_optimizer
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import make_train_step
from srcaco2_tpu_torch.utils import reproducibility as R

PG_TIMEOUT_S = 60


def spawn(target, world, tmp_path, payload=None, timeout=120, env=None):
    """target(rank, world, payload) in `world` processes of one gloo
    group; (exit codes, results or None per rank, seconds). A rank that
    outlives `timeout` is killed (exit code None before the kill)."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    tmp = str(tmp_path)
    inp = os.path.join(tmp, 'payload.pt')
    torch.save(payload, inp)
    store = os.path.join(tmp, f'store_{time.monotonic_ns()}')
    procs = [ctx.Process(target=_rank_main, args=(
        target, r, world, f'file://{store}', inp,
        os.path.join(tmp, f'out_{r}.pt'), env or {})) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = t0 + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    results = []
    for r in range(world):
        out = os.path.join(tmp, f'out_{r}.pt')
        results.append(torch.load(out, weights_only=False)
                       if os.path.isfile(out) else None)
    return codes, results, time.perf_counter() - t0


def _rank_main(target, rank, world, init, inp, out, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    from srcaco2_tpu_torch.parallel import mesh
    try:
        if target not in (main_rank, eval_rank):    # those join alone
            mesh.init_process_group('gloo', rank, world, init, PG_TIMEOUT_S)
        payload = torch.load(inp, weights_only=False)
        res = target(rank, world, {**(payload or {}), 'init': init})
        torch.save(res, out)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    if mesh.is_initialized():
        mesh.destroy_process_group()


# ------------------------------------------------------------- the step

def run_step(p, grid=None):
    """One train step call (or a superstep of len(p['idxs']) rows) of
    the payload's model from its state dict; the params, Adam moments,
    EMA, buffers, holder and ok after it."""
    model = p['cls'](device='cpu', **p['kw'])
    model.load_state_dict(p['state'])
    if p.get('rotations') is not None:
        model.rotations = p['rotations']
    args = p['args']
    tx = build_optimizer(args['train'])
    e_decay = float(p.get('e_decay', 0.0))
    st = TrainState.create(dict(model.named_parameters()), tx, e_decay)
    k = len(p['draws']) if isinstance(p['draws'], list) else 1
    step = make_train_step(model, build_loss(args), tx, p['net_type'],
                           p['cfg'], e_decay=e_decay, steps_per_epoch=1000,
                           ppiw_table=p.get('ppiw'),
                           steps_per_call=k if p.get('superstep') else 1,
                           grid=grid)

    def lsh(d, j):
        s = p.get('lsh_seed')
        return d if s is None else d._replace(lsh=R.lsh_generator(s, j))

    if isinstance(p['draws'], list):
        draws = [lsh(d, j) for j, d in enumerate(p['draws'])]
        if p.get('superstep'):
            st, holder, ok = step(st, p['hr'], p['lr'], p['idxs'], draws)
        else:
            hs, oks = [], []
            for j, d in enumerate(draws):
                st, h, o = step(st, p['hr'], p['lr'], p['idxs'][j], d)
                hs.append(h)
                oks.append(o)
            holder = {n: torch.stack([h[n] for h in hs]) for n in hs[0]}
            ok = torch.stack(oks).all()
    else:
        st, holder, ok = step(st, p['hr'], p['lr'], p['idxs'],
                              lsh(p['draws'], 0))
    clone = lambda t: {n: v.detach().clone() for n, v in t.items()}
    adam = st.opt_state.get('adam', {})
    return dict(params=clone(st.params), mu=clone(adam.get('mu', {})),
                nu=clone(adam.get('nu', {})),
                ema=clone(st.ema_params) if st.ema_params else None,
                buffers=clone(dict(model.named_buffers())),
                holder=clone(holder), ok=bool(ok), step=int(st.step))


def step_rank(rank, world, p):
    """This rank's step over the global batch on a data x model grid."""
    from srcaco2_tpu_torch.parallel import mesh
    grid = mesh.make_mesh(data=world // p.get('mesh_model', 1),
                          model=p.get('mesh_model', 1))
    if p.get('nan_rank') == rank:
        p = _plant_nan(p, grid)
    return run_step(p, grid)


def _plant_nan(p, grid):
    """A NaN in the Gaussian noise field of this rank's first sample (the
    local aug applied to every sample): a NaN LR input on one shard."""
    d = p['draws']
    field = d.gaus.field.clone()
    field[grid.rows(field.shape[0]).start] = float('nan')
    return {**p, 'draws': d._replace(gaus=d.gaus._replace(field=field))}


# ------------------------------------------------------------ the entry

WRITE_EVENTS = ('os.mkdir', 'os.rename', 'os.replace', 'os.remove',
                'shutil.copyfile', 'shutil.rmtree')


def audit_writes(root, log_path):
    """Record, one per line in log_path, every path under root that this
    process opens for writing, creates, renames or removes (sys audit
    events)."""
    root = os.path.abspath(root)
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

    def hook(event, args):
        if event == 'open':
            path, mode, flags = args
            writes = (isinstance(mode, str) and any(c in mode for c in 'wax+')
                      ) or (isinstance(flags, int) and flags & write_flags)
            paths = [path] if writes else []
        elif event in WRITE_EVENTS:
            paths = [a for a in args[:2] if isinstance(a, (str, bytes,
                                                          os.PathLike))]
        else:
            return
        for path in paths:
            try:
                path = os.path.abspath(os.fsdecode(path))
            except TypeError:
                continue
            if path.startswith(root + os.sep) or path == root:
                os.write(fd, (f'{event} {path}\n').encode())

    sys.addaudithook(hook)


def main_rank(rank, world, p):
    """`python -m srcaco2_tpu_torch.main` in this process as rank `rank`
    of a job started by a launcher (RANK, WORLD_SIZE, LOCAL_RANK), its
    process group over the file store; writes under p['cwd'] are
    audited into p['audit'] + rank. p['fail_eval_rank'] makes that
    rank's validation raise as a non-finite output does."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    os.chdir(p['cwd'])
    if p.get('audit'):
        audit_writes(p['cwd'], f"{p['audit']}{rank}.txt")
    if p.get('fail_eval_rank') == rank:
        from srcaco2_tpu_torch.train import trainer
        real = trainer.fast_eval

        def failing(forward, params, ds, *a, **k):
            def bad(pp, batch):
                out = forward(pp, batch)
                return out * float('nan')
            return real(bad, params, ds, *a, **k)
        trainer.fast_eval = failing
    from srcaco2_tpu_torch import main as M
    M.main(p['argv'] + ['--distributed', 'True', '--init_method', p['init'],
                        '--dist_timeout_s', str(PG_TIMEOUT_S)])
    return True


def eval_rank(rank, world, p):
    """`python -m srcaco2_tpu_torch.eval --distributed True` as rank
    `rank`; its summary."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from srcaco2_tpu_torch import eval as E
    return E.evaluate_pretrained(p['exp'], device='cpu', distributed=True,
                                 init_method=p['init'])


def fast_eval_rank(rank, world, p):
    """fast_eval of the bicubic forward over p['name'] on this rank of
    the grid: the rank's share of the batches, the results gathered."""
    from srcaco2_tpu_torch import constants
    from srcaco2_tpu_torch.config.parser import get_args
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.parallel import mesh
    from srcaco2_tpu_torch.train.evaluator import (fast_eval,
                                                   make_interpolate_forward)
    args = get_args(p['argv'])
    ds = load_dataset(args, p['name'], constants.EVAL_PHASE).stage('cpu')
    grid = mesh.make_mesh(world=world, rank=rank) if world > 1 else None
    return fast_eval(make_interpolate_forward(2, constants.INTER_BICUBIC),
                     None, ds, args, 1, constants.VALIDSET, grid=grid)
