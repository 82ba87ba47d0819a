"""The benchmark's traffic generator: one seeded labelled stream a replica.

A copy of the system's scenario generator (``Scenario`` / ``make_script``
in the serving layer's traffic module), cut to what the traffic mixes
state as data: each replica's stream walks seeded permutations of a row
pool (by index), one after another, with the pool's labels.

A stream is a pure function of (pool labels, replica, length, seed), so
the reference regenerates the sampled replicas' streams and every seed
gives every replica the same amount of work.
"""
from __future__ import annotations

import numpy as np

_STREAM = 0x5EED


def replica_stream(pool_y: np.ndarray, replica: int, length: int,
                   seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(pool rows [length] int64, labels [length] int32)."""
    pool_y = np.asarray(pool_y)
    P = len(pool_y)
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), _STREAM, int(replica)]))
    passes = -(-length // P)
    pick = np.concatenate([rng.permutation(P) for _ in range(passes)])
    pick = pick[:length].astype(np.int64)
    return pick, pool_y[pick].astype(np.int32)


def streams(pool_y: np.ndarray, replicas, length: int,
            seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The streams of the named replicas: ([S, length], [S, length])."""
    parts = [replica_stream(pool_y, int(r), length, seed) for r in replicas]
    return (np.stack([p[0] for p in parts]),
            np.stack([p[1] for p in parts]))
