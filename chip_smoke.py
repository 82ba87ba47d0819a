#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or a few):

1. device  -- the card, and its name and power limit from nvidia-smi;
2. build   -- the CUDA kernels built from ``src/repro_torch/kernels/csrc``;
3. parity  -- K1 ``clause_counts``, K2 ``clause_counts_batch`` and K8
   ``feedback_plane`` held to their plain PyTorch versions with
   ``torch.equal`` at the iris, ragged and full MNIST widths (K8 on int8
   and int16 banks), with the median time of each (CUDA graphs of
   back-to-back launches, timed by CUDA events) beside the plain
   version's and, for K1/K2, one float32 ``torch.matmul`` of the same
   contraction (a yardstick the port never calls);
4. main    -- the K = 1 ``TMService`` at the full MNIST width (f = 784):
   offline_train, submit + tick until drained with an ``on_chunk``
   monitor, and a 1024-row serve, through the kernels (backend "auto");
   then the same sequence with backend "ref" on the card, which must give
   the same TA bank, keys, reports, accuracies and predictions bit for bit.
   Every kernel must have launched during the "auto" run;
5. profile -- torch.profiler over one more 16-point drain chunk: wall
   time, device busy time, idle share, launches and the top kernels;
6. kernels -- one JSON line with each kernel's launches, error and times.

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

    recs = phase_parity(torch, np, ce, fb)
    launches = phase_main(torch, np, ce, fb)
    phase_profile(torch, np)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
