"""Shared arithmetic of the per-layer readers (``layers/<name>.py``).

Each function takes the run's record and, where it reads spans, the
name of the host span its metric is about ("tick" in the online cells),
and returns None when the run has nothing to read (no trace, no such
span), never 0.
"""
from __future__ import annotations

import counts
import harness

# Device kernels of the learning step by name: the fused Type I / II
# update (K9) and the training-mode clause counts (K3).
FEEDBACK = ("feedback_plane",)
CLAUSE = ("clause_counts_kernel", "clause_counts_vec_kernel")


def span_ms(run, name: str):
    """Mean milliseconds of the spans the profiler did not trace."""
    sps = [sp for sp in run.spans.get(name, []) if not sp.profiled]
    if not sps:
        return None
    return 1e3 * sum(sp.t1 - sp.t0 for sp in sps) / len(sps)


def launches_per_step(run, name: str):
    got = harness.launches_in(run, name)
    if got is None or got[1] == 0:
        return None
    return got[0] / got[1]


def roofline_pct(run, patterns, n_bytes: int):
    """100 x (bytes a call needs / 3.35 TB/s) / the kernel's mean device
    time a call."""
    got = harness.kernel_time(run, patterns)
    if got is None:
        return None
    seconds, calls = got
    return 100.0 * calls * n_bytes / counts.HBM_BYTES_PER_S / seconds


def feedback_roofline(run):
    s = run.shapes
    if not s:
        return None
    return roofline_pct(run, FEEDBACK, counts.feedback_bytes(
        s["R"], s["D"], s["C"], s["J"], s["L"], s["state_bytes"]))


def clause_roofline(run):
    s = run.shapes
    if not s:
        return None
    return roofline_pct(run, CLAUSE, counts.clause_bytes(
        s["R"], s["D"], s["C"], s["J"], s["L"]))


def idle_pct(run):
    bw = harness.busy_window(run)
    if bw is None:
        return None
    busy, window = bw
    return 100.0 * (1.0 - busy / window)


def mfu_pct(run, name: str):
    """100 x the learning steps' operations over (the untraced spans'
    seconds x 1,979 TOP/s)."""
    s = run.shapes
    sps = [sp for sp in run.spans.get(name, []) if not sp.profiled]
    if not s or not sps:
        return None
    ops = sum(sp.steps for sp in sps) * counts.learn_ops(
        s["R"], s["C"], s["J"], s["L"])
    seconds = sum(sp.t1 - sp.t0 for sp in sps)
    return 100.0 * ops / (seconds * counts.INT8_OPS_PER_S)
