"""The serving driver: the program's SRServer under one closed-loop
client, and the check of a sample of the served images against the plain
reference.

The client sends a request, waits for its images and sends the next, so
one request is in flight, as from one user's session. Each request is the
fields of view of one imaging session: `size` LR uint8 images in one
call. The sizes come in rounds that each hold every size of the mix's
range once, in an order drawn from the seed: every run serves the same
mix, and its seed draws the order, the images and the weights. A request
is timed from when it was sent to when its uint8 images are on the host.

`images_per_s` counts the images that the window's requests asked for and
received (padding slots not counted) over the seconds from the window's
start to its last answer, and `request_p95_ms` is the 95th percentile of
the latency of every request of the window.
"""
import math
import time

import numpy as np
import torch

from benchmark import core
from benchmark.drivers.train import weights
from benchmark.reference import common as RC


class Requests:
    """The client's requests, drawn from the run's seed as they are
    asked for: request i is (size, the pool images it sends)."""

    def __init__(self, tr: dict, seed: int, stream: str):
        lo, hi = tr['sizes']
        self.round = np.arange(lo, hi + 1)
        self.pool = int(tr['pool'])
        self.rng = np.random.default_rng(core.sub_seed(seed, stream))
        self.sizes, self.picks = [], []

    def __getitem__(self, i: int):
        while i >= len(self.sizes):
            for size in self.rng.permutation(self.round):
                self.sizes.append(int(size))
                self.picks.append(self.rng.integers(0, self.pool,
                                                    int(size)))
        return self.sizes[i], self.picks[i]


def make_pool(cell, seed: int, device) -> np.ndarray:
    """`pool` LR uint8 images (N, C, h, w), drawn on the device and kept
    on the host, where requests come from."""
    tr, cfg = cell.traffic, cell.cfg
    gen = torch.Generator(device=device).manual_seed(
        core.sub_seed(seed, 'images'))
    side = tr['lr_side']
    pool = torch.randint(0, 256, (tr['pool'], cfg['in_chans'], side, side),
                         generator=gen, device=device, dtype=torch.uint8)
    return pool.cpu().numpy()


def check_sample(sizes: list, tr: dict, seed: int) -> list:
    """The requests (of those served, with these sizes) whose images the
    check compares: the first of the longest, and others drawn from the
    seed."""
    longest = int(np.argmax(sizes))
    rest = [i for i in range(len(sizes)) if i != longest]
    rng = np.random.default_rng(core.sub_seed(seed, 'check'))
    k = min(len(rest), int(tr['check_requests']) - 1)
    return [longest] + sorted(int(i) for i in rng.choice(rest, k,
                                                          replace=False))


def serve_window(server, pool, reqs: Requests, seconds: float,
                 keep: bool = False):
    """Send requests back to back until `seconds` have passed; returns
    each request's latency (inf where it failed), its size, the images
    served, the window's seconds and, with `keep`, each request's output
    (None where it failed)."""
    lat, sizes, outs, images = [], [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        size, picks = reqs[len(lat)]
        lr = np.take(pool, picks, axis=0)
        sent = time.perf_counter()
        try:
            with core.span('request'):
                out = server(lr)
        except Exception as e:  # a failed request misses every limit
            print(f'request {len(lat)} failed: {e!r}', flush=True)
            lat.append(math.inf)
            out = None
        else:
            lat.append(time.perf_counter() - sent)
            images += size
        sizes.append(size)
        if keep:
            outs.append(out)
    return lat, sizes, images, time.perf_counter() - t0, outs


def reference_levels(cell, params: dict, device, lr_u8: np.ndarray,
                     precision: str = 'f32') -> torch.Tensor:
    """The reference's output levels (clipped to [0, 255], unrounded) of
    LR uint8 images, in blocks of the server's batch."""
    cfg, ref = cell.cfg, cell.reference()
    pr = RC.Precision(precision)
    out = []
    with torch.no_grad(), RC.true_f32():
        x = torch.from_numpy(lr_u8).to(device).float() / 255.0
        for s in range(0, x.shape[0], cell.traffic['server_batch']):
            y = ref.forward(params, x[s:s + cell.traffic['server_batch']],
                            cfg, pr)
            out.append(torch.clip(y, 0.0, 1.0) * 255.0)
    return torch.cat(out)


def image_gaps(served: np.ndarray, levels: torch.Tensor) -> list:
    """Per image, the root mean square gap in levels between the served
    uint8 image and the reference's levels."""
    s = torch.from_numpy(served).to(levels.device).float()
    d = (s - levels).reshape(s.shape[0], -1)
    return torch.sqrt((d * d).mean(1)).tolist()


class Program:
    """The program's server for the cell, built on weights from the
    seed."""

    def __init__(self, cell, seed: int, device):
        from srcaco2_tpu_torch.inference.serve import SRServer
        tr, cfg, port = cell.traffic, cell.cfg, cell.port()
        side = tr['lr_side']
        self.server = SRServer(
            args=port.port_args(cfg, side * cfg['scale']),
            state_dict=port.to_port(weights(cell, seed, device), cfg),
            batch_size=tr['server_batch'], lr_hw=(side, side),
            test_mode=0, device=device)

    def __call__(self, lr_u8: np.ndarray) -> np.ndarray:
        return self.server(lr_u8)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    """One run of a serving cell; see the module's docstring."""
    from srcaco2_tpu_torch.ops.build import build_all
    tr = cell.traffic
    cuda = device.type == 'cuda'
    mark = core.Marks(t_start)
    mark('imports')
    if cuda:
        build_all()
    mark('build')
    prog = Program(cell, seed, device)
    mark('server')
    pool = make_pool(cell, seed, device)
    mark('data')
    # one request of every batch count the mix sends warms its shapes
    for n in sorted({-(-s // tr['server_batch']) * tr['server_batch']
                     for s in range(tr['sizes'][0], tr['sizes'][1] + 1)}):
        prog(pool[:min(n, tr['sizes'][1])])
    mark('warm_requests')
    reqs = Requests(tr, seed, 'requests')
    if cuda:
        torch.cuda.synchronize(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    lat, sizes, images, window_s, kept = serve_window(prog, pool, reqs,
                                                      seconds, keep=True)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(1 for x in lat if not math.isfinite(x))
    p95_ms = core.percentile(lat, 95) * 1e3
    out = dict(setup_s=setup_s, window_s=window_s, attempted=len(lat),
               failed=failed, memory_peak_bytes=max(setup_peak, peak),
               e2e=dict(setup_s=setup_s, images_per_s=images / window_s,
                        request_p95_ms=p95_ms),
               obs=dict(cfg=cell.cfg, traffic=tr, images=images))
    if trace:
        # the device alone over trace_seconds of requests, then a few
        # requests with the host's ops, whose idle gaps say what the host
        # was doing
        with core.Traced(device) as traced:
            tlat, _, timages, traced_s, _ = serve_window(
                prog, pool, Requests(tr, seed, 'trace_requests'),
                float(tr['trace_seconds']))
        with core.Traced(device, host=True) as hosted:
            hlat = serve_window(prog, pool,
                                Requests(tr, seed, 'host_requests'), 0.5)[0]
        out['failed'] += sum(1 for x in tlat + hlat if not math.isfinite(x))
        out['attempted'] += len(tlat) + len(hlat)
        out['obs'].update(traced=traced.summary, traced_s=traced_s,
                          traced_samples=timages,
                          host_gaps=hosted.summary['idle_gaps'])
    del prog
    if cuda:
        torch.cuda.empty_cache()
    sample = check_sample(sizes, tr, seed)
    params, gaps = weights(cell, seed, device), []
    for i in sample:
        if kept[i] is not None:
            lr = np.take(pool, reqs[i][1], axis=0)
            gaps += image_gaps(kept[i], reference_levels(cell, params,
                                                         device, lr))
    out['checks'] = dict(image_rms_gap=max(gaps) if gaps else math.inf)
    out['notes'] = dict(setup_phases=mark.phases,
                        checked_images=len(gaps),
                        checked_requests=len(sample))
    return out
