"""Drive a cell on the CPU at a small size: the whole run except the
harness's look for a card (tests only)."""
from __future__ import annotations

import time

import harness
import run as run_mod


def cpu_run(name: str, seed: int = 2**31 + 17, seconds: float = 1.5,
            trace: bool = False, control=None, bench=None, config=None,
            **traffic):
    """Run cell ``name`` with its traffic's and configuration's keys
    overridden by ``traffic`` and ``config`` (a small copy)."""
    bench = bench or harness.load_benchmark()
    c = harness.cell(bench, name)
    tr = dict(c["traffic"], **traffic)
    cfg = dict(c["config"], **(config or {}))
    r = harness.Run(workload=name, seed=seed, seconds=seconds, trace=trace,
                    device="cpu", config=cfg, traffic=tr,
                    t_start=time.perf_counter(), control=control)
    return r, run_mod.execute(bench, r)


# small shapes of each cell's traffic, for CPU runs
IRIS = dict(replicas=8, check_replicas=8, check_serves=8, serve_rate=10)
# the MNIST machine at 6 clauses a class (its int16 bank and 784 inputs
# kept), two replicas and a small pool
MNIST = dict(replicas=2, check_replicas=2, check_serves=4, serve_rate=4,
             pool_rows=64, eval_rows=16, stream_rows=64, serve_rows=8)
MNIST_CONFIG = dict(n_clauses=6)
