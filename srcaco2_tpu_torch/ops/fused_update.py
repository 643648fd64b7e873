"""The train step's finite checks, optimizer chain, masked update and EMA
as one multi-tensor pass on the card (csrc/fused_update.cu).

The eager chain (train/schedule.py, train/state.py) runs each transform
over each leaf as its own launch, and builds its scalars with blocking
copies. `FusedUpdate` runs the same arithmetic in two launches a step, or
one pair per slice of the leaf table where it must be split, with its
scalars in device memory:

- the check launch (`begin`): the flag ok (the loss and every grad
  finite) and, with clipping, the grads' sum of squares; its last CTA
  advances the counts and computes the global norm, the bias corrections
  and the learning rate from them;
- the update launch (`apply`): per element, in optax's order, the grad
  zeroed where not ok, the clip, the L2 decay, the Adam / AMSGrad
  moments or the SGD trace (Nesterov), the schedule, the parameter kept
  where not ok, the EMA, and the corruption flag where a new parameter
  is not finite.

Everything is updated in place in the tensors the state holds. On the
card the pass is the only path: it takes f32 tensors on one card, the
parameters and states contiguous, and raises where they are not; a grad
that autograd returns in another memory format is copied to a
contiguous one. Where the parameters are on the CPU, `begin` launches
nothing and the step runs the eager chain. `launch_check` and
`launch_update` count their launches (ops/launches.py). `reference` is
the pass's plain version: the same formulas in the same order with torch
ops, on any device, which the CPU tests hold against the eager chain and
optax.
"""
import ctypes
import functools
import operator
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from srcaco2_tpu_torch import constants

CHUNK = 16384           # elements of one chunk, one CTA
DEPTH = 6               # grad, param, s1 (mu / trace), s2 (nu), s3, ema
MAX_LEAVES = 320        # leaves in one launch's table
MAX_CHUNKS = 1280       # chunks in one launch's table
MAX_MILESTONES = 16
HEADER_WORDS = 8        # csrc Header: ticket, ok, trigger, pad, 4 floats

PLAIN, ADAM, AMSGRAD, TRACE, NESTEROV = range(5)
MULTISTEP, MYSTEP = range(2)

# csrc Table
TABLE = np.dtype([('ptr', '<u8', (DEPTH, MAX_LEAVES)),
                  ('numel', '<i8', (MAX_LEAVES,)),
                  ('chunk_leaf', '<u2', (MAX_CHUNKS,)),
                  ('chunk_idx', '<u2', (MAX_CHUNKS,)),
                  ('n_chunks', '<i4'), ('block0', '<i4')])


class Hyper(ctypes.Structure):
    """csrc Hyper: the chain's constants, each a Python float rounded to
    f32 as the eager chain's scalar operands are."""
    _fields_ = ([(n, ctypes.c_int) for n in
                 ('kind', 'clip_on', 'wd_on', 'ema_on')]
                + [(n, ctypes.c_float) for n in
                   ('max_norm', 'wd', 'b1', 'b2', 'omb1', 'omb2', 'eps',
                    'mom', 'ema_d', 'ema_omd')]
                + [(n, ctypes.c_int) for n in
                   ('sched_kind', 'step_size', 'warm', 'n_ms')]
                + [(n, ctypes.c_float) for n in
                   ('base_lr', 'gamma', 'min_lr', 'inv_warm')]
                + [('ms', ctypes.c_int * MAX_MILESTONES)])


def kind_of(opts) -> int:
    """The moment transform of the chain."""
    if opts.kind == constants.ADAM:
        return AMSGRAD if opts.amsgrad else ADAM
    if opts.kind == constants.SGD:
        if opts.momentum > 0:
            return NESTEROV if opts.nesterov else TRACE
        return PLAIN
    raise NotImplementedError(opts.kind)


def make_hyper(opts, e_decay: float) -> Hyper:
    """The kernel's constants of the chain `opts` (train/schedule.py:
    ChainOptions) and the EMA decay."""
    if opts.schedule not in (constants.MULTISTEPLR, constants.MYSTEPLR):
        raise NotImplementedError(opts.schedule)
    if len(opts.milestones) > MAX_MILESTONES:
        raise ValueError(f'{len(opts.milestones)} milestones: the pass '
                         f'takes at most {MAX_MILESTONES}')
    h = Hyper(kind=kind_of(opts), clip_on=opts.clip > 0, wd_on=opts.wd > 0,
              ema_on=e_decay > 0, max_norm=opts.clip, wd=opts.wd,
              b1=opts.b1, b2=opts.b2, omb1=1 - opts.b1, omb2=1 - opts.b2,
              eps=opts.eps, mom=opts.momentum, ema_d=e_decay,
              ema_omd=1.0 - e_decay,
              sched_kind=(MYSTEP if opts.schedule == constants.MYSTEPLR
                          else MULTISTEP),
              step_size=opts.step_size, warm=opts.warmup,
              n_ms=len(opts.milestones), base_lr=opts.base_lr,
              gamma=opts.gamma, min_lr=opts.min_lr,
              inv_warm=(np.float32(1) / np.float32(opts.warmup)
                        if opts.warmup > 0 else 0.0))
    h.ms[:len(opts.milestones)] = opts.milestones
    return h


# ------------------------------------------------------------ the table

class Launch(NamedTuple):
    """One launch's slice of the leaves: the global index of each of its
    leaves, and per chunk (CTA) its leaf in `leaves` and its index in
    that leaf; `block0` is the launch's first CTA over all launches."""
    leaves: np.ndarray
    chunk_leaf: np.ndarray
    chunk_idx: np.ndarray
    block0: int


def plan(numels, chunk: int = CHUNK, max_leaves: int = MAX_LEAVES,
         max_chunks: int = MAX_CHUNKS) -> List[Launch]:
    """Cut leaves of `numels` elements into chunks of `chunk` elements,
    each inside one leaf, and the chunks into launches of at most
    `max_leaves` leaves and `max_chunks` chunks, in leaf order. A leaf
    may span launches; an empty leaf takes no chunk."""
    out, leaves, cl, ci = [], [], [], []
    block0 = 0

    def close():
        nonlocal leaves, cl, ci, block0
        if cl:
            out.append(Launch(np.array(leaves, np.int64),
                              np.array(cl, np.uint16),
                              np.array(ci, np.uint16), block0))
            block0 += len(cl)
        leaves, cl, ci = [], [], []

    for i, n in enumerate(numels):
        n_chunks = -(-int(n) // chunk)
        if n_chunks > 1 << 16:
            raise ValueError(f'leaf {i} of {n} elements: at most '
                             f'{(1 << 16) * chunk}')
        for c in range(n_chunks):
            if len(cl) == max_chunks or (
                    len(leaves) == max_leaves and leaves[-1] != i):
                close()
            if not leaves or leaves[-1] != i:
                leaves.append(i)
            cl.append(len(leaves) - 1)
            ci.append(c)
    close()
    return out


def _tables(launches: List[Launch], numels) -> List[np.ndarray]:
    """Each launch's csrc Table with its numels and chunks filled in; the
    pointers are filled in per step."""
    numels = np.asarray(numels, np.int64)
    out = []
    for la in launches:
        tab = np.zeros((), TABLE)
        tab['numel'][:len(la.leaves)] = numels[la.leaves]
        tab['chunk_leaf'][:len(la.chunk_leaf)] = la.chunk_leaf
        tab['chunk_idx'][:len(la.chunk_idx)] = la.chunk_idx
        tab['n_chunks'] = len(la.chunk_leaf)
        tab['block0'] = la.block0
        out.append(tab)
    return out


# ------------------------------------------------------------ the kernels

@functools.lru_cache(maxsize=None)
def _kernels():
    from srcaco2_tpu_torch.ops.build import library
    from srcaco2_tpu_torch.ops.swin_block import _bind
    lib = library('fused_update')
    layout = (ctypes.c_longlong * 11)()
    lib.fused_update_layout.argtypes = [ctypes.c_void_p]
    lib.fused_update_layout.restype = None
    lib.fused_update_layout(layout)
    want = (CHUNK, DEPTH, MAX_LEAVES, MAX_CHUNKS, MAX_MILESTONES,
            TABLE.itemsize, ctypes.sizeof(Hyper), 4 * HEADER_WORDS,
            TABLE.fields['numel'][1], TABLE.fields['chunk_leaf'][1],
            TABLE.fields['n_chunks'][1])
    if tuple(layout) != want:
        raise RuntimeError(f'csrc/fused_update.cu layout {tuple(layout)} '
                           f'is not the wrapper\'s {want}')
    check = _bind('fused_update', 'fused_update_check',
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])
    apply = _bind('fused_update', 'fused_update_apply',
                  [ctypes.c_void_p] * 5)
    return check, apply


def launch_check(table, hyper, args, device: int):
    """One check launch over the leaves of `table` (a csrc Table); `args`
    are the csrc CheckArgs after the table and the constants."""
    from srcaco2_tpu_torch.ops.swin_block import _launch
    (fn, name), _ = _kernels()
    _launch(fn, name, 'fused_update check',
            (table.ctypes.data, ctypes.addressof(hyper)) + args, device)
    launch_check.launches += 1


launch_check.launches = 0


def launch_update(table, hyper, header: int, flags: int, device: int):
    """One update launch over the leaves of `table`, from the scalars in
    the device header the check launches wrote."""
    from srcaco2_tpu_torch.ops.swin_block import _launch
    _, (fn, name) = _kernels()
    _launch(fn, name, 'fused_update apply',
            (table.ctypes.data, ctypes.addressof(hyper), header, flags),
            device)
    launch_update.launches += 1


launch_update.launches = 0


_F32 = torch.float32


def _refuse(what: str):
    raise ValueError(f'fused update on the card: {what}')


def _fits(col, numels, dev: int) -> bool:
    """Every tensor of `col` a contiguous f32 tensor on card `dev`, of
    its leaf's size."""
    return (all(t.dtype is _F32 for t in col)
            and all(t.get_device() == dev for t in col)
            and all(map(torch.Tensor.is_contiguous, col))
            and list(map(torch.Tensor.numel, col)) == numels)


def _addresses(col) -> np.ndarray:
    return np.fromiter(map(torch.Tensor.data_ptr, col), np.uint64,
                       len(col))


_DEPTHS = ('parameter', 'first moment or trace', 'second moment',
           'AMSGrad maximum', 'EMA')


class FusedUpdate:
    """The pass of one train step: the chain `opts` (train/schedule.py:
    ChainOptions, as build_optimizer's transformation carries it) and the
    EMA decay. It keeps its device scratch, the leaf plan and the last
    pointers of the parameters and states, by the identity of their
    tensors; the state's dicts are read on every call."""

    def __init__(self, opts, e_decay: float = 0.0):
        self.opts = opts
        self.e_decay = float(e_decay)
        self.kind = kind_of(opts)
        self.hyper = None                # made on the first card step
        self._cols = [None] * DEPTH      # (tensors, addresses) of 1..5
        self._numels = None
        self._plan = self._tabs = None
        self._scratch = self._flags = None
        self._device = None
        self._grads = None    # the grads the check read, until applied

    def _columns(self, state) -> list:
        """The tensors of depths 1..5 (param, s1, s2, s3, ema), None where
        the chain or the state has none."""
        params, opt = state.params, state.opt_state
        names = list(params)
        cols = [list(params.values()), None, None, None, None]
        try:
            if self.kind in (ADAM, AMSGRAD):
                adam = opt['adam']
                cols[1] = [adam['mu'][k] for k in names]
                cols[2] = [adam['nu'][k] for k in names]
                if self.kind == AMSGRAD:
                    cols[3] = [adam['nu_max'][k] for k in names]
            elif self.kind in (TRACE, NESTEROV):
                cols[1] = [opt['trace']['trace'][k] for k in names]
        except KeyError as e:
            _refuse(f'the optimizer state has no {e}')
        if self.e_decay > 0 and state.ema_params is not None:
            try:
                cols[4] = [state.ema_params[k] for k in names]
            except KeyError as e:
                _refuse(f'the EMA has no {e}')
        return cols

    def _counts(self, state, dev: int) -> list:
        """The Adam count (None without Adam) and the schedule's count,
        each an int32 scalar on card `dev`."""
        opt = state.opt_state
        counts = [opt['adam']['count'] if self.kind in (ADAM, AMSGRAD)
                  else None, opt['schedule']['count']]
        for c in counts:
            if c is not None and (c.dtype != torch.int32
                                  or c.get_device() != dev or c.numel() != 1):
                _refuse('the counts are not int32 scalars on the '
                        'parameters\' card')
        return counts

    def _cached(self, depth: int, col) -> bool:
        last = self._cols[depth]
        return (last is not None and len(last[0]) == len(col)
                and all(map(operator.is_, col, last[0])))

    def _replan(self, params, dev: int):
        """The plan, tables and scratch for these parameters' sizes on
        card `dev`, rebuilt where they changed."""
        numels = list(map(torch.Tensor.numel, params))
        if numels == self._numels and dev == self._device:
            return
        self._numels, self._device = numels, dev
        self._cols = [None] * DEPTH
        self._plan = plan(numels)
        self._tabs = _tables(self._plan, numels)
        total = sum(len(la.chunk_leaf) for la in self._plan)
        device = params[0].device
        self._scratch = torch.zeros(HEADER_WORDS + 2 * total,
                                    dtype=torch.int32, device=device)
        self._flags = torch.zeros(2, dtype=torch.bool, device=device)

    def begin(self, loss, grads, state) -> Optional[torch.Tensor]:
        """The path rule and the check launch. Returns None, launching
        nothing, where the parameters are on the CPU: the step runs the
        eager chain. On the card it launches the check and returns the
        step's flags (ok, corrupt), a bool (2,) tensor that `apply`
        completes and the next step's check launch overwrites, in stream
        order. There every parameter, grad and state tensor must be f32
        on the parameters' card, the parameters and states contiguous,
        and the counts int32 scalars; it raises ValueError otherwise. A
        grad in another memory format is copied to a contiguous one, and
        a loss in another float type is cast to f32."""
        params = list(state.params.values())
        if not params or params[0].get_device() < 0:
            return None
        dev = params[0].get_device()
        if self.hyper is None:
            try:
                self.hyper = make_hyper(self.opts, self.e_decay)
            except ValueError as e:
                _refuse(str(e))
        cols = self._columns(state)
        self.hyper.ema_on = cols[4] is not None
        if loss.get_device() != dev or loss.numel() != 1:
            _refuse('the loss is not a scalar on the parameters\' card')
        if not loss.is_floating_point():
            _refuse(f'the loss is {loss.dtype}')
        loss = loss.float()
        counts = self._counts(state, dev)
        try:
            # autograd may return a grad in another memory format than
            # its parameter (a convolution's channels-last weight grad)
            gcol = [g if g.is_contiguous() else g.contiguous()
                    for g in map(grads.__getitem__, state.params)]
        except KeyError as e:
            _refuse(f'no grad for the parameter {e}')
        if len(grads) != len(params):
            _refuse(f'{len(grads)} grads for {len(params)} parameters')
        if not self._cached(1, params):
            self._replan(params, dev)
        numels = self._numels
        if not _fits(gcol, numels, dev):
            _refuse('every grad must be an f32 tensor on the parameters\' '
                    'card, of its parameter\'s size')
        addr = [_addresses(gcol)]
        for depth, col in enumerate(cols, start=1):
            if col is None:
                addr.append(None)
                continue
            if not self._cached(depth, col):
                if not _fits(col, numels, dev):
                    self._cols[depth] = None
                    _refuse(f'every {_DEPTHS[depth - 1]} tensor must be a '
                            'contiguous f32 tensor on the parameters\' '
                            'card, of its parameter\'s size')
                self._cols[depth] = (col, _addresses(col))
            addr.append(self._cols[depth][1])
        for la, tab in zip(self._plan, self._tabs):
            rows = tab['ptr']
            for depth, a in enumerate(addr):
                rows[depth, :len(la.leaves)] = (0 if a is None
                                                else a[la.leaves])
        self._check(loss, counts)
        self._grads = gcol
        return self._flags

    def _pointers(self):
        base = self._scratch.data_ptr()
        total = (self._scratch.numel() - HEADER_WORDS) // 2
        return (base, base + 4 * HEADER_WORDS,
                base + 4 * (HEADER_WORDS + total), total)

    def _check(self, loss, counts):
        header, bad, ss, total = self._pointers()
        adam, sched = (None if c is None else c.data_ptr() for c in counts)
        last = len(self._tabs) - 1
        for i, tab in enumerate(self._tabs):
            launch_check(tab, self.hyper,
                         (loss.data_ptr(), adam, sched, header, bad, ss,
                          self._flags.data_ptr(), int(i == last), total),
                         self._device)

    def apply(self):
        """The update launch(es) of the step `begin` checked: the chain,
        the masked update, the EMA and the corruption flag."""
        header = self._scratch.data_ptr()
        for tab in self._tabs:
            launch_update(tab, self.hyper, header, self._flags.data_ptr(),
                          self._device)
        self._grads = None


# ------------------------------------------------------- plain version

def _safe_increment(c: int) -> int:
    return c + 1 if c < 2 ** 31 - 1 else c


def _f32(x) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def schedule_lr(h: Hyper, count: int) -> torch.Tensor:
    """csrc schedule_lr: the learning rate at `count`, an f32 scalar."""
    one = _f32(1.0)
    if h.sched_kind == MYSTEP:
        pw = torch.pow(_f32(h.gamma), _f32(count // h.step_size))
        lr = torch.clamp(_f32(h.base_lr) * pw, min=_f32(h.min_lr))
    else:
        lr = _f32(h.base_lr)
        for m in h.ms[:h.n_ms]:
            ind = one if m - count > 0 else _f32(0.0)
            lr = lr * ind + ((one - ind) * _f32(h.gamma)) * lr
    if h.warm > 0:
        lr = lr * torch.clamp(_f32(count + 1) * _f32(h.inv_warm), max=one)
    return lr


def prologue(h: Hyper, ok: bool, sumsq, counts) -> dict:
    """csrc check_kernel's last CTA: the step's scalars from ok, the sum
    of squares and the counts {'adam': int or None, 'schedule': int};
    the advanced counts under the same keys."""
    gnorm = torch.sqrt(sumsq) if h.clip_on and ok else _f32(0.0)
    out = dict(ok=ok, gnorm=gnorm,
               trigger=not h.clip_on or bool(gnorm < _f32(h.max_norm)),
               bc1=_f32(1.0), bc2=_f32(1.0))
    if counts['adam'] is not None:
        c = _safe_increment(counts['adam'])
        out['adam'] = c
        out['bc1'] = _f32(1.0) - torch.pow(_f32(h.b1), _f32(c))
        out['bc2'] = _f32(1.0) - torch.pow(_f32(h.b2), _f32(c))
    out['schedule'] = _safe_increment(counts['schedule'])
    out['step'] = _f32(-1.0) * schedule_lr(h, counts['schedule'])
    return out


def reference(opts, e_decay: float, loss, grads, state):
    """The pass in plain torch ops, in its order of operations, in place
    on `state` (params, opt_state, ema_params) as the kernels update it.
    Returns (ok, corrupt) as bool scalars on the parameters' device."""
    h, kind = make_hyper(opts, e_decay), kind_of(opts)
    params, opt = state.params, state.opt_state
    names = list(params)
    ok = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(grads[k]).all()) for k in names)
    sumsq = _f32(0.0)
    if h.clip_on:
        for k in names:
            g = grads[k].detach().float().cpu()
            sumsq = sumsq + torch.sum(g * g)
    adam = opt.get('adam')
    s = prologue(h, ok, sumsq, dict(
        adam=None if adam is None else int(adam['count']),
        schedule=int(opt['schedule']['count'])))
    if adam is not None:
        adam['count'].fill_(s['adam'])
    opt['schedule']['count'].fill_(s['schedule'])
    bad = False
    with torch.no_grad():
        for k in names:
            p = params[k]
            dev = p.device
            c = {n: v.to(dev) for n, v in s.items() if torch.is_tensor(v)}

            def f(x):
                return _f32(x).to(dev)
            u = grads[k] if ok else torch.zeros_like(p)
            if not s['trigger']:
                u = (u / c['gnorm']) * f(h.max_norm)
            if h.wd_on:
                u = u + f(h.wd) * p
            if kind in (ADAM, AMSGRAD):
                mu, nu = adam['mu'][k], adam['nu'][k]
                m = f(h.omb1) * u + f(h.b1) * mu
                v = f(h.omb2) * (u * u) + f(h.b2) * nu
                mu.copy_(m)
                nu.copy_(v)
                vh = v / c['bc2']
                if kind == AMSGRAD:
                    vh = torch.maximum(adam['nu_max'][k], vh)
                    adam['nu_max'][k].copy_(vh)
                u = (m / c['bc1']) / (torch.sqrt(vh) + f(h.eps))
            elif kind in (TRACE, NESTEROV):
                tr = opt['trace']['trace'][k]
                new = u + f(h.mom) * tr
                tr.copy_(new)
                u = u + f(h.mom) * new if kind == NESTEROV else new
            u = c['step'] * u
            if ok:
                p.copy_(p + u)
            bad = bad or not bool(torch.isfinite(p).all())
            if h.ema_on:
                e = state.ema_params[k]
                e.copy_(f(h.ema_d) * e + f(h.ema_omd) * p)
    dev = next(iter(params.values())).device
    return (torch.tensor(ok, device=dev), torch.tensor(bad, device=dev))
