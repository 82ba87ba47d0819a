#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each with its seconds:

1. device  -- the card, and its name and power limit from nvidia-smi;
2. build   -- the CUDA kernels built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together);
3. parity  -- every kernel held to its plain PyTorch version with
   ``torch.equal``: K1 ``clause_counts``, K2 ``clause_counts_batch`` and K8
   ``feedback_plane`` at the iris, ragged and full MNIST widths (K8 on
   int8 and int16 banks); K3 ``clause_counts_replicated``, K4
   ``clause_counts_batch_replicated`` (B = 1, 7, 150) and K9
   ``feedback_plane_replicated`` (int8 and int16) at (R, D, CJ, L) =
   (6, 3, 48, 32), (3, 1, 12, 33), (4, 2, 12, 513), (8, 8, 640, 1568)
   and (16, 4, 640, 1568). Beside each, at the main path's shapes, the
   median time of the kernel (CUDA graphs of back-to-back launches, timed
   by CUDA events), of its plain version and, for the clause counts, of
   one float32 ``torch.matmul``/``torch.bmm`` of the same contraction (a
   yardstick the port never calls);
4. service -- the K = 1 ``TMService`` at the full MNIST width (f = 784):
   offline_train, submit + tick until drained with an ``on_chunk``
   monitor, and a 1024-row serve, through the kernels (backend "auto");
   then the same sequence with backend "ref" on the card, which must give
   the same TA bank, keys, reports, accuracies and predictions bit for bit.
   K1, K2 and K8 must each have launched during the "auto" run;
5. paper   -- the paper's iris setup at full scale through the
   replica-first engine: ``manager.run_orderings`` over all 120 block
   orderings, SystemConfig(10, 16), for the three use cases (online
   learning §5.1, class introduction §5.2, stuck-at faults §5.3), and
   ``CrossValRun.sweep`` over 120 orderings x s {1.375, 2.0, 3.0} x
   T {5, 10, 15} (R = 1080), 10 epochs. Backend "auto", then "ref": the
   curves, banks and accuracies must be bitwise equal;
6. wide    -- the same engine at the full MNIST width (f = 784):
   ``run_orderings`` with O = 8, SystemConfig(2, 2), and a sweep of
   O = 4 x s {1.5, 2.0} x T {24, 32} (R = 16), 1 epoch; "auto" then
   "ref", bitwise equal. K3, K4 and K9 must each have launched exactly as
   often as the code says during the "auto" runs of phases 5 and 6;
7. profile -- torch.profiler over one more 16-point drain chunk of the
   service, and over one offline epoch of the f = 784, O = 8 engine: wall
   time, device busy time, idle share, launches (per step) and the top
   kernels;
8. kernels -- one JSON line with each kernel's launches (phase 4 for K1,
   K2, K8; phase 6 for K3, K4, K9), error and times.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits nonzero. Without a CUDA device, or without the
port's sources beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2023
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core rate
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
FULL = (640, 1568)            # MNIST preset: 10 x 64 clause rows, 2 x 784 literals
SHAPES = [(48, 32), (12, 33), (12, 513), FULL]
# Replica-first shapes (R, D, CJ, L); WIDE is the f = 784 system's step.
WIDE = (8, 8) + FULL
REP_SHAPES = [(6, 3, 48, 32), (3, 1, 12, 33), (4, 2, 12, 513), WIDE,
              (16, 4) + FULL]
B_ANALYSIS = 150              # one fused three-set analysis: 30 + 60 + 60 rows


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, inner: int = 20, reps: int = 15) -> float:
    """Median device time of one ``fn()``: a CUDA graph of ``inner``
    back-to-back calls, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_parity(torch, np, ce, fb):
    """K1/K2/K8 against their plain versions; returns the kernel records
    at the main path's full-width shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    err = {"clause_counts": 0, "clause_counts_batch": 0, "feedback_plane": 0}

    def rand_bool(shape, p):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    def max_err(got, want):
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    for cj, L in SHAPES:
        inc = rand_bool((cj, L), 0.05)
        batches = (1, 128, 1024) if (cj, L) == FULL else (1, 7)
        for B in batches:
            lits = rand_bool((B, L), 0.5)
            got = ce.clause_counts_batch(inc, lits)
            want = ce.clause_counts_batch_plain(inc, lits)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            err["clause_counts_batch"] = max(err["clause_counts_batch"],
                                             max_err(got, want))
            print(f"parity K2 clause_counts_batch CJ={cj} L={L} B={B} "
                  f"equal={ok}", flush=True)
            check(ok, f"K2 differs from its plain version at {cj, L, B}")
        got = ce.clause_counts(inc, lits[0])
        want = ce.clause_counts_plain(inc, lits[0])
        torch.cuda.synchronize()
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err["clause_counts"] = max(err["clause_counts"], max_err(got, want))
        print(f"parity K1 clause_counts CJ={cj} L={L} equal={ok}", flush=True)
        check(ok, f"K1 differs from its plain version at {cj, L}")
        for dtype, n_states in ((torch.int8, 63), (torch.int16, 5000)):
            ta = torch.from_numpy(rng.integers(
                1, 2 * n_states + 1, (cj, L))).to(dtype).to(dev)
            ctl = [rand_bool((cj,), 0.5) for _ in range(3)]
            u = torch.from_numpy(rng.random((cj, L), dtype=np.float32)).to(dev)
            args = (ta, lits[0], *ctl, u, 0.75, 1.0 / 3.0)
            got = fb.feedback_plane(*args, n_states=n_states)
            want = fb.feedback_plane_plain(*args, n_states=n_states)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err["feedback_plane"] = max(err["feedback_plane"],
                                        max_err([got], [want]))
            print(f"parity K8 feedback_plane CJ={cj} L={L} {dtype} "
                  f"equal={ok}", flush=True)
            check(ok, f"K8 differs from its plain version at {cj, L, dtype}")

    # Times at the main path's shapes: K1 and K8 once per training step,
    # K2 at the 1024-row serve.
    cj, L = FULL
    B = 1024
    inc = rand_bool((cj, L), 0.05)
    lits = rand_bool((B, L), 0.5)
    ta = torch.from_numpy(rng.integers(1, 127, (cj, L))).to(torch.int8).to(dev)
    ctl = [rand_bool((cj,), 0.5) for _ in range(3)]
    u = torch.from_numpy(rng.random((cj, L), dtype=np.float32)).to(dev)
    inc_f = inc.to(torch.float32)
    rhs1 = torch.stack([1.0 - lits[0].float(), torch.ones(L, device=dev)], 1)
    rhsb = torch.cat([(1.0 - lits.float()).T,
                      torch.ones(L, 1, device=dev)], 1)
    fb_args = (ta, lits[0], *ctl, u, 0.75, 1.0 / 3.0)
    recs = []
    for name, src, replaces, kern, plain, lib, nbytes, ops, rate in (
        ("clause_counts", "clause_eval.cu",
         "src/repro/kernels/clause_eval.py:78",
         lambda: ce.clause_counts(inc, lits[0]),
         lambda: ce.clause_counts_plain(inc, lits[0]),
         lambda: inc_f @ rhs1,
         cj * L + L + 2 * cj * 4, 2.0 * cj * L * 2, INT8_OPS_PER_S),
        ("clause_counts_batch", "clause_eval.cu",
         "src/repro/kernels/clause_eval.py:130",
         lambda: ce.clause_counts_batch(inc, lits),
         lambda: ce.clause_counts_batch_plain(inc, lits),
         lambda: inc_f @ rhsb,
         cj * L + B * L + cj * B * 4 + cj * 4, 2.0 * cj * L * (B + 1),
         INT8_OPS_PER_S),
        ("feedback_plane", "feedback.cu",
         "src/repro/kernels/feedback.py:91",
         lambda: fb.feedback_plane(*fb_args, n_states=63),
         lambda: fb.feedback_plane_plain(*fb_args, n_states=63),
         None,
         2 * cj * L + 4 * cj * L + L + 3 * cj, 10.0 * cj * L, F32_OPS_PER_S),
    ):
        b_ms, b_by = bound(nbytes, ops, rate)
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else time_ms(torch, lib),
        }
        print(f"time {name}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms, library {rec['library_ms']} ms, "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)
        recs.append(rec)
    return recs


def phase_parity_replicated(torch, np, ce, fb):
    """K3/K4/K9 against their plain versions; returns the kernel records
    at the f = 784 system's shapes (R = D = 8, K4 at B = 150)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    err = {"clause_counts_replicated": 0,
           "clause_counts_batch_replicated": 0,
           "feedback_plane_replicated": 0}

    def rand_bool(shape, p):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    def max_err(got, want):
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err[name] = max(err[name], max_err(got, want))
        print(f"parity {name} {what} equal={ok}", flush=True)
        check(ok, f"{name} differs from its plain version at {what}")

    for R, D, cj, L in REP_SHAPES:
        inc = rand_bool((R, cj, L), 0.05)
        for B in (1, 7, B_ANALYSIS):
            lits = rand_bool((D, B, L), 0.5)
            hold("clause_counts_batch_replicated",
                 ce.clause_counts_batch_replicated(inc, lits),
                 ce.clause_counts_batch_replicated_plain(inc, lits),
                 f"R={R} D={D} CJ={cj} L={L} B={B}")
        hold("clause_counts_replicated",
             ce.clause_counts_replicated(inc, lits[:, 0]),
             ce.clause_counts_replicated_plain(inc, lits[:, 0]),
             f"R={R} D={D} CJ={cj} L={L}")
        for dtype, n_states in ((torch.int8, 63), (torch.int16, 5000)):
            ta = torch.from_numpy(rng.integers(
                1, 2 * n_states + 1, (R, cj, L))).to(dtype).to(dev)
            ctl = [rand_bool((R, cj), 0.5) for _ in range(3)]
            u = torch.from_numpy(rng.random((D, cj, L),
                                            dtype=np.float32)).to(dev)
            ps, pe = (torch.from_numpy(rng.random(R, dtype=np.float32))
                      .to(dev) for _ in range(2))
            args = (ta, lits[:, 0], *ctl, u, ps, pe)
            hold("feedback_plane_replicated",
                 [fb.feedback_plane_replicated(*args, n_states=n_states)],
                 [fb.feedback_plane_replicated_plain(*args,
                                                     n_states=n_states)],
                 f"R={R} D={D} CJ={cj} L={L} {dtype}")

    # Times at the f = 784 system's shapes: K3 and K9 once per training
    # step, K4 once per cycle over the three concatenated sets.
    R, D, cj, L = WIDE
    B = B_ANALYSIS
    inc = rand_bool((R, cj, L), 0.05)
    lits = rand_bool((D, B, L), 0.5)
    ta = torch.from_numpy(rng.integers(1, 127, (R, cj, L))).to(
        torch.int8).to(dev)
    ctl = [rand_bool((R, cj), 0.5) for _ in range(3)]
    u = torch.from_numpy(rng.random((D, cj, L), dtype=np.float32)).to(dev)
    ps = torch.full((R,), 0.75, device=dev)
    pe = torch.full((R,), 1.0 / 3.0, device=dev)
    fb_args = (ta, lits[:, 0], *ctl, u, ps, pe)
    rows = torch.arange(R, device=dev) % D
    inc_f = inc.to(torch.float32)
    rhs1 = torch.stack([1.0 - lits[:, 0].float(),
                        torch.ones(D, L, device=dev)], -1)[rows]
    rhsb = torch.cat([(1.0 - lits.float()).transpose(1, 2),
                      torch.ones(D, L, 1, device=dev)], -1)[rows]
    recs = []
    for name, replaces, kern, plain, lib, nbytes, ops, rate in (
        ("clause_counts_replicated", "src/repro/kernels/clause_eval.py:193",
         lambda: ce.clause_counts_replicated(inc, lits[:, 0]),
         lambda: ce.clause_counts_replicated_plain(inc, lits[:, 0]),
         lambda: torch.bmm(inc_f, rhs1),
         R * cj * L + D * L + 2 * R * cj * 4, 2.0 * R * cj * L * 2,
         INT8_OPS_PER_S),
        ("clause_counts_batch_replicated",
         "src/repro/kernels/clause_eval.py:254",
         lambda: ce.clause_counts_batch_replicated(inc, lits),
         lambda: ce.clause_counts_batch_replicated_plain(inc, lits),
         lambda: torch.bmm(inc_f, rhsb),
         R * cj * L + D * B * L + R * cj * B * 4 + R * cj * 4,
         2.0 * R * cj * L * (B + 1), INT8_OPS_PER_S),
        ("feedback_plane_replicated", "src/repro/kernels/feedback.py:145",
         lambda: fb.feedback_plane_replicated(*fb_args, n_states=63),
         lambda: fb.feedback_plane_replicated_plain(*fb_args, n_states=63),
         None,
         2 * R * cj * L + 4 * D * cj * L + D * L + 3 * R * cj + 8 * R,
         10.0 * R * cj * L, F32_OPS_PER_S),
    ):
        src = "feedback.cu" if name.startswith("feedback") else \
            "clause_eval.cu"
        b_ms, b_by = bound(nbytes, ops, rate)
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else time_ms(torch, lib),
        }
        print(f"time {name} (R={R} D={D} CJ={cj} L={L}"
              f"{f' B={B}' if 'batch' in name else ''}): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, library "
              f"{rec['library_ms']} ms, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
        recs.append(rec)
    return recs


def run_service(torch, np, cfg, data, on_chunk):
    """The main path: offline_train -> submit + tick -> serve. Returns
    the service, its reports, the served predictions and the timings."""
    from repro_torch import random as rnd
    from repro_torch.core import init_state
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs_off, ys_off, xs_on, ys_on, xs_ev, ys_ev, xs_serve = data
    svc = TMService(
        cfg, init_state(cfg, rnd.PRNGKey(SEED, "cuda"), device="cuda"),
        ServiceConfig(replicas=1, buffer_capacity=128, chunk=16, s=2.0, T=32,
                      policy=AdaptPolicy(analyze_every=32), seed=SEED),
        eval_x=xs_ev, eval_y=ys_ev, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = svc.offline_train(xs_off, ys_off, n_epochs=2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for x, y in zip(xs_on, ys_on):
        check(svc.submit(0, x, int(y)), "a submitted row was refused")
    reports = []
    while int(svc.buffered[0]):
        reports.append(svc.tick(on_chunk=on_chunk))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    served = svc.serve(xs_serve)
    t3 = time.perf_counter()
    timing = {"offline_points_per_s": 2 * len(xs_off) / (t1 - t0),
              "drain_points_per_s": len(xs_on) / (t2 - t1),
              "serve_ms": (t3 - t2) * 1e3}
    return svc, base, reports, served, timing


def phase_main(torch, np, ce, fb):
    from repro_torch.configs import tm_mnist
    from repro_torch.data import mnist

    xs, ys = mnist.load(seed=SEED, n_points=296)
    xs_serve, _ = mnist.load(seed=SEED + 1, n_points=1024)
    data = (xs[:100], ys[:100], xs[100:196], ys[100:196], xs[196:],
            ys[196:], xs_serve)
    cfg = tm_mnist.CONFIG.tm
    check(cfg.n_features == 784 and cfg.backend == "auto",
          "the preset is not the full-width machine on backend auto")

    runs = {}
    for backend in ("auto", "ref"):
        chunks = []
        c = dataclasses.replace(cfg, backend=backend)
        if backend == "auto":
            ce.clause_counts.launches = 0
            ce.clause_counts_batch.launches = 0
            fb.feedback_plane.launches = 0
        runs[backend] = run_service(torch, np, c, data, chunks.append) + (
            chunks,)
        if backend == "auto":
            launches = {"clause_counts": ce.clause_counts.launches,
                        "clause_counts_batch": ce.clause_counts_batch.launches,
                        "feedback_plane": fb.feedback_plane.launches}
    a, r = runs["auto"], runs["ref"]
    svc_a, base_a, rep_a, served_a, timing, chunks_a = a
    svc_r, base_r, rep_r, served_r, _, chunks_r = r

    def same(x, y):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        return x.shape == y.shape and np.array_equal(x, y)

    check(torch.equal(svc_a.ss.tm.ta_state, svc_r.ss.tm.ta_state),
          "TA banks differ between the kernels and the plain versions")
    check(same(svc_a.rng_keys, svc_r.rng_keys), "RNG keys differ")
    check(same(base_a, base_r), "offline accuracies differ")
    check(len(rep_a) == len(rep_r), "tick counts differ")
    for x, y in zip(rep_a, rep_r):
        check(same(x.trained, y.trained) and same(x.rolled_back, y.rolled_back)
              and (x.accuracy is None) == (y.accuracy is None)
              and (x.accuracy is None or same(x.accuracy, y.accuracy)),
              "tick reports differ")
    check(len(svc_a.history) == len(svc_r.history)
          and all(same(s1, s2) and same(a1, a2) for (s1, a1), (s2, a2)
                  in zip(svc_a.history, svc_r.history)),
          "analysis histories differ")
    check(len(chunks_a) == len(chunks_r) and all(
        same(getattr(x, f).cpu(), getattr(y, f).cpu())
        for x, y in zip(chunks_a, chunks_r) for f in x._fields),
        "chunk monitoring differs")
    check(same(served_a, served_r), "served predictions differ")

    accs = [float(acc[0]) for _, acc in svc_a.history]
    check(served_a.shape == (1, 1024) and served_a.min() >= 0
          and served_a.max() < cfg.max_classes, "served predictions malformed")
    check(all(np.isfinite(acc) and 0.0 <= acc <= 1.0 for acc in accs),
          "accuracies not in [0, 1]")
    check(int(svc_a.steps[0]) == 96 and int(svc_a.buffered[0]) == 0,
          "the drain did not consume every submitted row")
    check(len(chunks_a) > 0, "the monitor saw no chunk")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    print(f"main TMService f=784 K=1: offline acc {float(base_a[0]):.4f}, "
          f"analysis accs {[round(x, 4) for x in accs]}, "
          f"ticks {len(rep_a)}, auto == ref bitwise: True", flush=True)
    print(f"main throughput: offline_train "
          f"{timing['offline_points_per_s']:.2f} points/s, drain "
          f"{timing['drain_points_per_s']:.2f} points/s, serve(1024) "
          f"{timing['serve_ms']:.3f} ms", flush=True)
    print(f"main launches: {json.dumps(launches)}", flush=True)
    return launches


def _sets(np, osets, offline_limit):
    """A numpy ``Sets`` over every ordering, as the figure benchmarks build
    it: the offline set is analyzed whole and trained on its first
    ``offline_limit`` rows."""
    from repro_torch.core.manager import Sets

    O, n_off = osets.offline_y.shape
    train_valid = np.ones((O, n_off), dtype=bool)
    if offline_limit is not None:
        train_valid[:, offline_limit:] = False
    return Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((O, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=train_valid)


def phase_engine(torch, np, ce, fb, label, params, osets, sys_cfg, cases,
                 sweep):
    """``run_orderings`` for each (name, schedule, offline_limit) case and
    one ``CrossValRun.sweep`` (s_values, T_values, n_epochs, n_orderings),
    through backend "auto" and then "ref" on the card. Checks that both
    agree bit for bit and that the outputs are well formed, prints the
    curves and rates, checks the K3/K4/K9 launches of the "auto" runs
    against the counts the code implies, and returns them with each
    case's mean accuracy curve."""
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.core import manager as mgr
    from repro_torch.core.tm import init_runtime
    from repro_torch.eval.crossval import CrossValRun, replicate_state

    dev = torch.device("cuda")
    O, n_off = osets.offline_y.shape
    n_onl = osets.online_y.shape[1]
    s_values, T_values, sweep_epochs, sweep_o = sweep
    counters = {"clause_counts_replicated": ce.clause_counts_replicated,
                "clause_counts_batch_replicated":
                    ce.clause_counts_batch_replicated,
                "feedback_plane_replicated": fb.feedback_plane_replicated}
    out = {}
    for backend in ("auto", "ref"):
        cfg = dataclasses.replace(params.tm, backend=backend)
        for c in counters.values():
            c.launches = 0
        runs = {}
        for name, schedule, limit in cases:
            sets = convert.sets_from_numpy(_sets(np, osets, limit), dev)
            keys = rnd.split(rnd.PRNGKey(0, dev), O)
            rt = init_runtime(cfg, s=params.s_offline, T=params.T,
                              device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, accs, act = mgr.run_orderings(
                cfg, sys_cfg, replicate_state(cfg, O, dev), rt, sets,
                schedule, keys)
            torch.cuda.synchronize()
            runs[name] = (st.ta_state, accs, act, time.perf_counter() - t)
        res = CrossValRun(cfg, device=dev).sweep(
            osets.offline_x[:sweep_o], osets.offline_y[:sweep_o],
            osets.validation_x[:sweep_o], osets.validation_y[:sweep_o],
            s_values, T_values, n_epochs=sweep_epochs, seed=0)
        launches = {k: c.launches for k, c in counters.items()}
        out[backend] = (runs, res, launches)

    (runs_a, res_a, launches), (runs_r, res_r, _) = out["auto"], out["ref"]
    steps = sys_cfg.n_offline_epochs * n_off + sys_cfg.n_online_cycles * n_onl
    for name, _, _ in cases:
        st_a, accs_a, act_a, wall = runs_a[name]
        st_r, accs_r, act_r, wall_r = runs_r[name]
        check(torch.equal(st_a, st_r), f"{label} {name}: banks differ "
              "between the kernels and the plain versions")
        check(torch.equal(accs_a, accs_r), f"{label} {name}: accuracies "
              "differ between the kernels and the plain versions")
        check(torch.equal(act_a, act_r), f"{label} {name}: activity differs")
        acc = accs_a.cpu().numpy()
        check(acc.shape == (O, 1 + sys_cfg.n_online_cycles, 3)
              and np.isfinite(acc).all() and acc.min() >= 0.0
              and acc.max() <= 1.0, f"{label} {name}: accuracies malformed")
        check(act_a.shape == (O, sys_cfg.n_online_cycles)
              and bool(torch.isfinite(act_a).all()),
              f"{label} {name}: activity malformed")
        curve = acc.mean(axis=0)
        print(f"{label} run_orderings {name} O={O}: mean validation "
              f"accuracy {curve[0, 1]:.4f} -> {curve[-1, 1]:.4f} (offline "
              f"{curve[0, 0]:.4f} -> {curve[-1, 0]:.4f}, online "
              f"{curve[0, 2]:.4f} -> {curve[-1, 2]:.4f}), auto == ref "
              f"bitwise: True; auto {wall:.3f} s = {O * steps / wall:.1f} "
              f"replica-steps/s, ref {wall_r:.3f} s", flush=True)
    check(torch.equal(res_a.val_accuracy, res_r.val_accuracy),
          f"{label} sweep: validation accuracies differ between the kernels "
          "and the plain versions")
    va = res_a.val_accuracy.cpu().numpy()
    check(va.shape == (len(s_values), len(T_values), sweep_o)
          and np.isfinite(va).all() and va.min() >= 0.0 and va.max() <= 1.0,
          f"{label} sweep: accuracies malformed")
    mean = res_a.mean_accuracy.cpu().numpy()
    i, j = np.unravel_index(np.argmax(mean), mean.shape)
    print(f"{label} sweep R={res_a.replicas} (O={sweep_o} x s {s_values} x "
          f"T {T_values}, {sweep_epochs} epochs): best s={s_values[i]} "
          f"T={T_values[j]} mean val acc {mean[i, j]:.4f}; auto "
          f"{res_a.wall_s:.3f} s = {res_a.replicas_per_s:.2f} replicas/s = "
          f"{res_a.replicas * sweep_epochs * n_off / res_a.wall_s:.1f} "
          f"replica-steps/s, ref {res_r.wall_s:.3f} s; auto == ref bitwise: "
          "True", flush=True)

    # The counts the code implies: one K3 + K9 per datapoint step, one K4
    # per analysis block (offline, then once per cycle), one for the sweep.
    n_sys = len(cases)
    want = {"clause_counts_replicated":
            n_sys * steps + sweep_epochs * n_off,
            "clause_counts_batch_replicated":
            n_sys * (1 + sys_cfg.n_online_cycles) + 1}
    want["feedback_plane_replicated"] = want["clause_counts_replicated"]
    print(f"{label} launches (auto): {json.dumps(launches)}, from the code: "
          f"{json.dumps(want)}", flush=True)
    check(launches == want, f"{label}: kernel launches differ from the "
          "counts the code implies")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a replica-first kernel never launched")
    curves = {name: runs_a[name][1].mean(dim=0).cpu().numpy()
              for name, _, _ in cases}
    return launches, curves


def phase_paper(torch, np, ce, fb):
    """The paper's iris setup at full scale (120 orderings, 10 offline
    epochs, 16 cycles) for its three use cases, and the 1080-replica
    sweep."""
    from repro_torch.configs import tm_iris
    from repro_torch.core import faults
    from repro_torch.core import manager as mgr
    from repro_torch.data import blocks

    params = tm_iris.CONFIG
    osets, _ = blocks.iris_paper_sets(n_orderings=params.n_orderings)
    check(osets.offline_x.shape == (120, 30, 16),
          "the iris paper sets are not 120 orderings of 30 x 16")
    masks = faults.even_spread_stuck_at(params.tm, 0.2, 0)
    s_onl = params.s_online
    cases = [
        ("online_learning", mgr.make_schedule(online_s=s_onl),
         params.offline_limit),
        ("class_introduction", mgr.make_schedule(
            online_s=s_onl, filtered_class=0, introduce_at_cycle=5), None),
        ("faults", mgr.make_schedule(online_s=s_onl, fault_masks=masks,
                                     inject_at_cycle=5),
         params.offline_limit),
    ]
    launches, curves = phase_engine(
        torch, np, ce, fb, "paper", params, osets,
        mgr.SystemConfig(params.n_offline_epochs, params.n_online_cycles),
        cases, ((1.375, 2.0, 3.0), (5, 10, 15), params.n_offline_epochs,
                120))
    # The paper's Fig-4 claim at full scale, as the repo's own full-scale
    # test holds the reference to it: online learning on labelled data
    # raises the validation and online-set accuracy.
    c = curves["online_learning"]
    gain_val, gain_onl = c[-1, 1] - c[0, 1], c[-1, 2] - c[0, 2]
    print(f"paper Fig-4 gains (mean over 120 orderings): validation "
          f"{gain_val:+.4f}, online {gain_onl:+.4f}", flush=True)
    check(gain_val >= 0.04 and gain_onl >= 0.04,
          "online learning did not raise the accuracy (Fig. 4)")
    return launches


def phase_wide(torch, np, ce, fb):
    """The engine at the full MNIST width (f = 784): 8 orderings through
    the Fig-3 flow and a 16-replica sweep."""
    from repro_torch.configs import tm_mnist
    from repro_torch.core import manager as mgr
    from repro_torch.data import blocks

    params = tm_mnist.CONFIG
    check(params.tm.n_features == 784 and params.tm.backend == "auto",
          "the preset is not the full-width machine on backend auto")
    osets, _ = blocks.mnist_paper_sets(n_orderings=8)
    cases = [("online_learning", mgr.make_schedule(online_s=params.s_online),
              params.offline_limit)]
    launches, _ = phase_engine(torch, np, ce, fb, "wide", params, osets,
                               mgr.SystemConfig(2, 2), cases,
                               ((1.5, 2.0), (24, 32), 1, 4))
    return launches


def phase_profile_epoch(torch, np):
    """Where one offline epoch of the f = 784, O = 8 system goes:
    torch.profiler over ``train_epochs_replicated`` for one epoch (30
    steps), after the main paths, so no launch count includes it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.configs import tm_mnist
    from repro_torch.core import feedback as fb_mod
    from repro_torch.core.manager import train_valid
    from repro_torch.core.tm import init_runtime
    from repro_torch.data import blocks
    from repro_torch.eval.crossval import replicate_state

    params = tm_mnist.CONFIG
    cfg = params.tm
    dev = torch.device("cuda")
    osets, _ = blocks.mnist_paper_sets(n_orderings=8)
    sets = convert.sets_from_numpy(_sets(np, osets, params.offline_limit),
                                   dev)
    O, n = osets.offline_y.shape
    rt = init_runtime(cfg, s=params.s_offline, T=params.T, device=dev)
    keys = rnd.split(rnd.PRNGKey(1, dev), O)

    def epoch():
        return fb_mod.train_epochs_replicated(
            cfg, replicate_state(cfg, O, dev), rt, sets.offline_x,
            sets.offline_y, keys, 1, valid=train_valid(sets))

    epoch()                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    devk = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in devk) / 1e3
    launches = sum(e.count for e in ka
                   if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    top = sorted(devk, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile offline epoch (O={O}, {n} steps, f={cfg.n_features}): "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.4f}, kernel launches {launches} "
          f"({launches / n:.1f} per step)", flush=True)
    print("profile epoch top device kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top), flush=True)


def phase_profile(torch, np):
    """Where one drain chunk's time goes: torch.profiler over one tick of
    16 points at the full width (after the main path, so no launch count
    of the main path includes it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import tm_mnist
    from repro_torch.core import init_state
    from repro_torch.data import mnist
    from repro_torch.serve import ServiceConfig, TMService

    cfg = tm_mnist.CONFIG.tm
    xs, ys = mnist.load(seed=SEED + 2, n_points=32)
    svc = TMService(cfg, init_state(cfg, device="cuda"),
                    ServiceConfig(chunk=16, s=2.0, T=32), device="cuda")
    for x, y in zip(xs, ys):
        svc.submit(0, x, int(y))
    svc.tick()                       # warm: first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.tick(on_chunk=lambda aux: None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile drain chunk (16 points, f=784): wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.4f}, kernel launches {launches}", flush=True)
    print("profile top device kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top), flush=True)


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from repro_torch.kernels import _build
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb

    t = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(p.name for p in built.values())} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.2f} s", flush=True)
        return out

    recs = timed("parity", phase_parity, torch, np, ce, fb)
    recs += timed("parity_replicated", phase_parity_replicated, torch, np,
                  ce, fb)
    launches = timed("service", phase_main, torch, np, ce, fb)
    paper = timed("paper", phase_paper, torch, np, ce, fb)
    launches.update(timed("wide", phase_wide, torch, np, ce, fb))
    check(all(n > 0 for n in paper.values()),
          "a replica-first kernel never launched on the paper path")
    timed("profile", phase_profile, torch, np)
    timed("profile_epoch", phase_profile_epoch, torch, np)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
