"""The traffic of a cell: batches of a problemset's queries, each handed to
the adaptive planner whole, one after the other (a closed loop with one
client: a planning service draining a queue of problemsets).

The batches come from a pool of ``pool`` batches fixed by :data:`POOL_SEED`:
pool batch ``j`` holds ``rows`` queries, the problemset's ``Q``
queries tiled and rotated by ``j`` (row ``i`` is query ``(i + j) % Q``), and
its own seed for the planner's draws. A run sends the pool's batches in an
order drawn from the run's seed (batch ``k`` is pool batch ``perm[k % pool]``),
so every seed sends the same batches and the same work, in another order:
how many restarts a batch needs follows its draws, and with a window of a few
batches, batches drawn afresh from every seed moved the rate by more than
runs of one seed did.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

POOL_SEED = 20  # the seed of the pool's batches, the same in every run


def queries(states: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Every pair of the problemset's states, ``(starts [Q, L], goals [Q, L])``."""
    pairs = list(itertools.combinations(range(len(states)), 2))
    return states[[a for a, _ in pairs]], states[[b for _, b in pairs]]


def batch(starts: np.ndarray, goals: np.ndarray, rows: int, j: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pool batch ``j``'s queries: ``rows`` of them, tiled and rotated by ``j``."""
    idx = (np.arange(rows) + j) % len(starts)
    return starts[idx], goals[idx]


def seed_of(seed: int, k: int, stream: int = 0) -> int:
    """A 32-bit seed drawn from the run's ``seed`` (any integer), the batch
    ``k`` and a ``stream`` (0: the batch's own seed)."""
    return int(np.random.SeedSequence((int(seed) % 2 ** 64, int(k), int(stream))).generate_state(1)[0])


def pool_batch(seed: int, k: int, pool: int) -> Tuple[int, int]:
    """Batch ``k`` of a run seeded ``seed``: ``(j, planner seed)``, ``j`` the
    pool batch it sends (its rotation) and the seed of that batch's draws."""
    perm = np.random.default_rng(seed_of(seed, 0, 5)).permutation(pool)
    j = int(perm[k % pool])
    return j, seed_of(POOL_SEED, j)
