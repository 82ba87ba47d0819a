"""The inputs of a run, made from its seed: the row pool the streams
draw from, the eval set of the accuracy analysis, and the rows of each
serve request. Both the system and the reference get the same arrays.

* ``iris``: the 150 booleanised iris rows (16 inputs, 3 classes) are the
  pool; the eval set is a 30-row block of a seeded permutation of them.
* ``digits``: the procedural booleanised digits (784 inputs, 10 classes):
  ``pool_rows`` rows for the streams and ``eval_rows`` held-out rows,
  rendered from the seed.
"""
from __future__ import annotations

import numpy as np

from tmdata import digits, iris

_EVAL = 0xE7A1
_SERVE = 0x5E7E


def pool_and_eval(config: dict, traffic: dict, seed: int):
    """(pool_x [P, f] bool, pool_y [P] int32, eval_x [E, f], eval_y [E])."""
    kind = config["data"]
    if kind == "iris":
        x, y = iris.raw()
        xs = iris.booleanize(x, iris.thermometer_thresholds(x)).astype(bool)
        ys = y.astype(np.int32)
        rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                            _EVAL]))
        ev = rng.permutation(len(ys))[:traffic["eval_rows"]]
        return xs, ys, xs[ev], ys[ev]
    if kind == "digits":
        n_pool, n_eval = traffic["pool_rows"], traffic["eval_rows"]
        xs, ys = digits.load(seed=int(seed), n_points=n_pool + n_eval,
                             side=config["side"])
        return xs[:n_pool], ys[:n_pool], xs[n_pool:], ys[n_pool:]
    raise ValueError(f"unknown data {kind!r}")


def serve_rows(n_pool: int, n_requests: int, rows: int,
               seed: int) -> np.ndarray:
    """Pool rows of every serve request: [n_requests, rows] int64, row
    set q drawn from (seed, q) alone."""
    return np.stack([
        np.random.default_rng(np.random.SeedSequence(
            [int(seed), _SERVE, q])).integers(0, n_pool, rows)
        for q in range(n_requests)]) if n_requests else \
        np.zeros((0, rows), dtype=np.int64)
