"""The generators repeat for a seed, and every seed gets the same work in
another order."""
import time

import numpy as np
import torch

from benchmark.drivers import serve as S
from benchmark.drivers import train as T
from conftest import tiny_cell

BIG = 2 ** 31 + 12345      # seeds are larger than 32 signed bits hold
CPU = torch.device('cpu')


def test_training_draws_and_stacks_repeat_for_a_seed():
    cell = tiny_cell('tiny_swinir.train')
    a, b = T.Draws(cell, BIG, CPU), T.Draws(cell, BIG, CPU)
    for _ in range(3):
        for x, y in zip(a.next(), b.next()):
            assert torch.equal(x, y)
    other = T.Draws(cell, BIG + 1, CPU).next()
    assert not torch.equal(other[1], T.Draws(cell, BIG, CPU).next()[1])
    hr1, lr1 = T.make_stacks(cell, BIG, CPU)
    hr2, lr2 = T.make_stacks(cell, BIG, CPU)
    assert torch.equal(hr1, hr2) and torch.equal(lr1, lr2)
    tr = cell.traffic
    idxs, x0, y0, mode = a.next()
    assert idxs.shape == (tr['batch'],)
    assert int(x0.max()) <= tr['hr_side'] - tr['h_size']
    assert int(mode.max()) < 8


def test_weights_repeat_for_a_seed():
    cell = tiny_cell('tiny_swinir.train')
    w1, w2 = T.weights(cell, BIG, CPU), T.weights(cell, BIG, CPU)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_serving_requests_repeat_and_give_every_seed_the_same_mix():
    cell = tiny_cell('tiny_swinir.serve')
    tr = dict(cell.traffic, sizes=[1, 16], pool=64)
    a = S.Requests(tr, BIG, 'requests')
    b = S.Requests(tr, BIG, 'requests')
    c = S.Requests(tr, BIG + 1, 'requests')
    n = 16 * 5
    for i in range(n):
        assert a[i][0] == b[i][0]
        assert np.array_equal(a[i][1], b[i][1])
        assert len(a[i][1]) == a[i][0]
        c[i]
    # every round of 16 requests holds each size once, in an order and
    # with images that the seed draws
    for r in range(0, n, 16):
        assert sorted(a.sizes[r:r + 16]) == list(range(1, 17))
        assert sorted(c.sizes[r:r + 16]) == list(range(1, 17))
    assert a.sizes[:n] != c.sizes[:n]
    assert max(int(p.max()) for p in a.picks) < tr['pool']
    # the check's sample: the first of the longest, then drawn from the
    # seed, the same for the same seed
    sample = S.check_sample(a.sizes[:n], tr, BIG)
    assert sample == S.check_sample(b.sizes[:n], tr, BIG)
    assert a.sizes[sample[0]] == 16 and a.sizes.index(16) == sample[0]
    assert len(set(sample)) == tr['check_requests']


def test_serving_metrics_count_every_request_of_the_window():
    """images_per_s and request_p95_ms are taken over all requests of the
    window, each timed from its sending to its answer."""
    cell = tiny_cell('tiny_swinir.serve')
    tr = dict(cell.traffic, sizes=[1, 4], pool=8)
    served = []

    def server(lr):
        served.append(len(lr))
        time.sleep(0.004 * len(lr))
        return np.zeros((len(lr), 1, 2, 2), np.uint8)

    pool = np.zeros((8, 1, 2, 2), np.uint8)
    reqs = S.Requests(tr, BIG, 'requests')
    lat, sizes, images, window_s, outs = S.serve_window(server, pool, reqs,
                                                        0.3, keep=True)
    assert len(lat) == len(sizes) == len(outs) == len(served) >= 8
    assert sizes == served == reqs.sizes[:len(sizes)]
    assert images == sum(sizes)
    assert window_s >= 0.3
    # each latency is its own request's service time
    for x, s in zip(lat, sizes):
        assert 0.004 * s <= x < 0.004 * s + 0.05
    p95 = S.core.percentile(lat, 95)
    assert p95 >= 0.004 * 3
