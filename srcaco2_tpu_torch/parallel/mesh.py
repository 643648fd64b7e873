"""Data parallelism over torch.distributed (port of
srcaco2_tpu/parallel/mesh.py).

The JAX package jits its step over a `data` x `model` device mesh with
global-array semantics: the sharded step equals the one-device step over
the whole batch, up to the order of its sums. The port runs one process
per card (torchrun, or SLURM's variables: `launcher_world`) and gets the
same step so:

- every rank stages the whole split and draws the global batch (its
  indices from utils/reproducibility.epoch_indices, its random choices
  from step_generator), then takes its own rows (`shard_train_step`);
- the gradients are averaged over the ranks in one all-reduce of one
  flat f32 buffer per update (`Grid.all_reduce_grads`), before the
  finite check, so that the skip, Adam, the EMA and the flags see the
  global gradient on every rank (train/steps.py);
- the loss holder is averaged by one more all-reduce, so that every
  rank logs the global loss; l2sum, a sum over the batch, is scaled by
  the number of data shards so that its average is the global sum
  (losses/master.py);
- BatchNorm in training normalises with the statistics of the global
  batch (`sync_batch_norm`, models/blocks.py:BatchNorm);
- `fast_eval` gives each rank every world-th batch and sums the
  per-image metrics over the ranks (train/evaluator.py).

The grid: rank r holds data shard r // model, so the `model` ranks of a
shard compute the same step, as JAX's model axis replicates it; the
average over all ranks equals the average over the shards. data * model
must equal the world size: a process of torchrun cannot sit idle as an
extra JAX device does.
"""
import datetime as dt
import os
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.data.pipeline import BlockAug, Draws

DATA = constants.DATA_AXIS
MODEL = constants.MODEL_AXIS

Tensors = Dict[str, torch.Tensor]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def device_count() -> int:
    """The job's devices: one per process."""
    return dist.get_world_size() if is_initialized() else 1


def is_master() -> bool:
    return process_index() == 0


def launcher_world(env: Mapping[str, str] = os.environ
                   ) -> Tuple[int, int, int]:
    """(rank, world size, local rank) from torchrun's RANK, WORLD_SIZE
    and LOCAL_RANK, else from SLURM's SLURM_PROCID, SLURM_NTASKS and
    SLURM_LOCALID. With neither RANK nor SLURM_PROCID the world is one
    process. A launcher's rank without its world size raises."""
    for rank_key, world_key, local_key in (
            ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'),
            ('SLURM_PROCID', 'SLURM_NTASKS', 'SLURM_LOCALID')):
        if rank_key in env:
            if world_key not in env:
                raise RuntimeError(f'{rank_key} is set but {world_key} is '
                                   f'not: start the job with torchrun or '
                                   f'srun')
            return (int(env[rank_key]), int(env[world_key]),
                    int(env.get(local_key, 0)))
    return 0, 1, 0


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str = '', timeout_s: float = 1800,
                       device=None) -> None:
    """torch.distributed.init_process_group with an explicit timeout,
    then one all-reduce on `device` (NCCL creates its communicator at
    the first collective, so a failing NCCL fails here). The rendezvous:
    `init_method` if given (file:///path, tcp://host:port), else env://
    (MASTER_ADDR, MASTER_PORT), else, for a world of one, a store in
    this process. Whatever the backend raises propagates: nothing falls
    back to another backend or device."""
    kw = dict(backend=backend, rank=rank, world_size=world_size,
              timeout=dt.timedelta(seconds=float(timeout_s)))
    if init_method:
        kw['init_method'] = init_method
    elif world_size == 1 and 'MASTER_ADDR' not in os.environ:
        kw['store'] = dist.HashStore()
    else:
        kw['init_method'] = 'env://'
    dist.init_process_group(**kw)
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f'the first all-reduce counted {int(probe)} '
                           f'processes of {world_size}')


def destroy_process_group(device=None) -> None:
    """Every rank waits for the others (an all-reduce on `device`, which
    NCCL runs on the rank's own card), then leaves the process group."""
    dist.all_reduce(torch.zeros(1, device=device))
    dist.destroy_process_group()


@dataclass(frozen=True)
class Grid:
    """The data x model grid of the ranks, and its collectives (over the
    default process group)."""
    data: int
    model: int = 1
    rank: int = 0

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def shard(self) -> int:
        """This rank's data shard."""
        return self.rank // self.model

    @property
    def shape(self) -> dict:
        return {DATA: self.data, MODEL: self.model}

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n."""
        if n % self.data:
            raise ValueError(f'batch {n} not divisible by the data axis '
                             f'{self.data}')
        per = n // self.data
        return slice(self.shard * per, (self.shard + 1) * per)

    def all_reduce_grads(self, grads: Tensors) -> Tensors:
        """The mean of every rank's grads: one all-reduce of one flat f32
        buffer, then a division by the world size."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1).float() for k in names])
        dist.all_reduce(flat)
        flat = flat / self.world
        out, off = {}, 0
        for k in names:
            g = grads[k]
            out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of t, as a new tensor."""
        t = t.clone()
        dist.all_reduce(t)
        return t

    def broadcast_int(self, v: int, device=None) -> int:
        """Rank 0's v on every rank."""
        t = torch.tensor([int(v)], dtype=torch.int64, device=device)
        dist.broadcast(t, 0)
        return int(t.item())

    def barrier(self, device=None) -> None:
        """Every rank waits here for the others (an all-reduce on
        `device`, which NCCL runs on the rank's own card)."""
        dist.all_reduce(torch.zeros(1, device=device))


def make_mesh(args: Optional[dict] = None, data: Optional[int] = None,
              model: int = 1, rank: Optional[int] = None,
              world: Optional[int] = None) -> Grid:
    """The grid from the config's mesh_data / mesh_model (-1 or 0 data:
    world // model), or from data / model; rank and world default to the
    process group's. data * model must be the world size."""
    world = device_count() if world is None else int(world)
    rank = process_index() if rank is None else int(rank)
    if args is not None:
        model = int(args.get('mesh_model', 1) or 1)
        data = int(args.get('mesh_data', -1))
    if data in (None, -1, 0):
        data = world // model
    if data < 1 or data * model != world:
        raise ValueError(f'mesh_data {data} x mesh_model {model} must equal '
                         f'the world size {world}')
    return Grid(data=data, model=model, rank=rank)


def shard_draws(draws: Draws, rows: slice) -> Draws:
    """The rows of a batch's draws; the hash-rotation generator (lsh)
    stays whole: its draws do not depend on the batch (NLSN's rotations
    are (1, c, hashes, buckets))."""
    def aug(a):
        return None if a is None else BlockAug(*(f[rows] for f in a))
    return draws._replace(x0=draws.x0[rows], y0=draws.y0[rows],
                          mode=draws.mode[rows], blur=aug(draws.blur),
                          dot=aug(draws.dot), gaus=aug(draws.gaus))


def shard_train_step(step_fn: Callable, grid: Grid) -> Callable:
    """A (state, hr_u8, lr_u8, idxs, draws) step for one update that
    takes this rank's rows of the global idxs (B,) and draws."""
    def sharded(state, hr_u8, lr_u8, idxs, draws):
        rows = grid.rows(idxs.shape[-1])
        return step_fn(state, hr_u8, lr_u8, idxs[rows],
                       shard_draws(draws, rows))
    return sharded


def sync_batch_norm(model: torch.nn.Module, grid: Optional[Grid]) -> None:
    """Every BatchNorm of `model` takes its training statistics over the
    global batch (grid) or over its own (None)."""
    from srcaco2_tpu_torch.models.blocks import BatchNorm
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reduce = None if grid is None else grid.all_reduce_sum
