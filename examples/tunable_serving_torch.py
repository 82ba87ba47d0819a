"""Runtime-tunable serving on the PyTorch/CUDA port (DESIGN.md §16): one
fleet, three budgets.

Offline-trains a K-member fleet, calibrates per-replica clause rankings
from the eval set, then serves the SAME traffic burst at compute budgets
100% / 50% / 25% — printing held-out accuracy, serve latency, and (with
early exit on) how many clauses each request actually evaluated. The
100% row is bitwise the plain serve path; the lower rows trade accuracy
for latency without retraining or a rebuild — the knob a latency-pressured
deployment turns.

    python examples/tunable_serving_torch.py [--replicas 4] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch.core import TMConfig, init_state
from repro_torch.core.tm import resolve_device
from repro_torch.data import iris
from repro_torch.serve import ServiceConfig, TMService, TunableConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    K = args.replicas
    dev = resolve_device(args.device)

    cfg = TMConfig(n_features=16, max_classes=3, max_clauses=16,
                   n_states=50)
    xs, ys = iris.load()
    svc = TMService(
        cfg, init_state(cfg, device=dev),
        ServiceConfig(
            replicas=K, buffer_capacity=32, chunk=8,
            s=1.375, T=15, seed=list(range(K)),
            tunable=TunableConfig(budget=1.0, early_exit=True, group=4),
        ),
        eval_x=xs[100:], eval_y=ys[100:], device=dev,
    )

    base = svc.offline_train(xs[:80], ys[:80], n_epochs=10)
    print(f"offline eval accuracy per replica: "
          f"{[round(float(a), 3) for a in base]}")
    svc.calibrate()
    print(f"calibrated: per-replica clause rankings over "
          f"{cfg.max_clauses} clauses\n")

    burst_x, burst_y = xs[100:], ys[100:]
    rows = {}
    print("budget  m   accuracy  serve_ms  clauses evaluated (min/mean)")
    for budget in (1.0, 0.5, 0.25):
        # warm the path for this budget before timing
        svc.serve(burst_x, budget=budget)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        preds, aux = svc.serve(burst_x, budget=budget, return_aux=True)
        ms = (time.perf_counter() - t0) * 1e3
        acc = float((preds == burst_y[None]).mean())
        rows[budget] = (aux.m, acc, ms)
        print(f"{budget:6.0%}  {aux.m:2d}  {acc:8.3f}  {ms:8.2f}  "
              f"{aux.evaluated.min():3d} / {aux.evaluated.mean():.1f}")

    # the 100% budget row IS the plain serve path, bit for bit — the
    # early-exit bound is prediction-invariant, so even with exit on the
    # full-budget predictions match the unbudgeted contraction exactly
    np.testing.assert_array_equal(svc.serve(burst_x, budget=1.0),
                                  preds_full(svc, burst_x))
    print("\nbudget=100% verified bitwise against the plain serve path")
    return {"base": base, "rows": rows}


def preds_full(svc, xs):
    """The unbudgeted serve path (tuner bypassed) for the parity check."""
    from repro_torch.core import tm as tm_mod

    return tm_mod.predict_batch_replicated(
        svc.cfg, svc._ss.tm, svc.rt,
        torch.as_tensor(np.asarray(xs), device=svc.device)[None]
    ).cpu().numpy()


if __name__ == "__main__":
    main()
