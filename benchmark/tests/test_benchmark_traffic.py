"""The traffic: the problemset's queries tiled and rotated a batch, seeds drawn
from the run's seed and the batch."""

import numpy as np

from benchmark.harness import traffic


def test_queries_are_every_pair_of_states():
    states = np.arange(9 * 7, dtype=float).reshape(9, 7)
    s, g = traffic.queries(states)
    assert len(s) == 36
    np.testing.assert_array_equal(s[0], states[0])
    np.testing.assert_array_equal(g[0], states[1])
    np.testing.assert_array_equal(s[-1], states[7])
    np.testing.assert_array_equal(g[-1], states[8])


def test_batches_tile_and_rotate_the_queries():
    s = np.arange(36, dtype=float)[:, None]
    g = s + 100
    b0, _ = traffic.batch(s, g, 512, 0)
    b5, g5 = traffic.batch(s, g, 512, 5)
    assert b0.shape == (512, 1)
    np.testing.assert_array_equal(b0[:, 0], np.arange(512) % 36)
    np.testing.assert_array_equal(b5[:, 0], (np.arange(512) + 5) % 36)
    np.testing.assert_array_equal(g5[:, 0], b5[:, 0] + 100)
    # each query appears 14 or 15 times, whatever the rotation
    counts = np.bincount(b5[:, 0].astype(int), minlength=36)
    assert set(counts) == {14, 15}


def test_seeds_are_fixed_by_the_run_seed_and_differ_by_batch_and_stream():
    big = 2 ** 31 + 12345
    assert traffic.seed_of(big, 0) == traffic.seed_of(big, 0)
    seeds = {traffic.seed_of(big, k) for k in range(50)}
    assert len(seeds) == 50
    assert traffic.seed_of(big, 0, 0) != traffic.seed_of(big, 0, 1)
    assert traffic.seed_of(big, 0) != traffic.seed_of(big + 1, 0)
    assert all(0 <= s < 2 ** 32 for s in seeds)
    assert traffic.seed_of(-3, 1) == traffic.seed_of(2 ** 64 - 3, 1)


def test_every_seed_sends_the_same_pool_in_another_order():
    orders = []
    for seed in (1, 2 ** 31 + 99, 77):
        sent = [traffic.pool_batch(seed, k, 4) for k in range(8)]
        assert sorted(j for j, _ in sent[:4]) == [0, 1, 2, 3]
        assert sent[4:] == sent[:4]
        assert all(b == traffic.seed_of(traffic.POOL_SEED, j) for j, b in sent)
        orders.append([j for j, _ in sent[:4]])
    assert len({tuple(o) for o in orders}) > 1
    assert traffic.pool_batch(5, 3, 4) == traffic.pool_batch(5, 3, 4)
