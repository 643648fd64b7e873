"""Seeds and the port's random-draw scheme (port of
srcaco2_tpu/utils/reproducibility.py).

JAX derives every step's patch origins and dihedral modes from
`fold_in(key, step)` and each epoch's permutation from
`fold_in(key, epoch)` (data/pipeline.py:228-230), so a run of K steps per
call, of one step per call, and a resumed run all follow one trajectory.
The port keeps that property with one torch.Generator per draw, seeded
from (myseed, stream, index): `step_generator` for a step's draws (on the
card, where the stacks live), `lsh_generator` for a step's hash
rotations (NLSN; on the CPU, so that the card and the CPU draw alike),
`epoch_generator` for an epoch's permutation. A single stateful
generator would tie the draws to the order of calls and break resume
and the superstep. The port cannot
replay JAX's draws (torch and JAX have different generators); the tests
hold the trainer's parts against JAX with the draws injected.
"""
import random

import numpy as np
import torch

_STEP, _EPOCH, _LSH = 1, 2, 3


def set_seed(seed: int):
    """Seed the host RNGs (python, numpy) and torch's default generator;
    the training draws do not use them."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def derived_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for the stream (seed, *stream), independent of the
    order in which streams are asked for."""
    ss = np.random.SeedSequence([seed % (2 ** 32)]
                                + [s % (2 ** 32) for s in stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step `step`'s draws (pipeline.draw)."""
    return _generator(derived_seed(seed, _STEP, step), device)


def lsh_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`'s hash rotations (JAX: the
    step key's 'lsh' stream, train/steps.py:120-122)."""
    return _generator(derived_seed(seed, _LSH, step), 'cpu')


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of epoch `epoch`'s permutation of the train set."""
    return _generator(derived_seed(seed, _EPOCH, epoch), device)


def epoch_indices(seed: int, n: int, epoch: int, device) -> torch.Tensor:
    """Per-epoch permutation of [0, n) on `device` (DistributedSampler
    analog; JAX: pipeline.epoch_indices)."""
    return torch.randperm(n, generator=epoch_generator(seed, epoch, device),
                          device=device)
