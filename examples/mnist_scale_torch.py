"""MNIST-scale serving demo on the PyTorch/CUDA port: the TMService flow
at a wide datapath.

The same submit -> tick -> serve loop as examples/serve_fleet_torch.py,
but on the generated booleanized digit workload (10 classes, f = side**2
boolean inputs; side 28 = the paper-benchmark MNIST width). Rows flow
straight from the generator into the service — no host-side reshaping at
any width; ``--side`` is the only knob that changes the datapath.

    python examples/mnist_scale_torch.py               # 14x14 (f=196)
    python examples/mnist_scale_torch.py --side 28     # full MNIST width
    python examples/mnist_scale_torch.py --device cpu  # on the CPU

It runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.configs import tm_mnist
from repro_torch.core import init_state
from repro_torch.core.tm import resolve_device
from repro_torch.data import mnist
from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService


def run(side: int = 14, replicas: int = 2, epochs: int = 4,
        cycles: int = 16, device=None) -> dict:
    dev = resolve_device(device)
    params = tm_mnist.config_for_side(side)
    cfg = params.tm
    print(f"datapath: f={cfg.n_features} ({side}x{side}), "
          f"{cfg.max_classes} classes x {cfg.max_clauses} clauses, "
          f"TA bank {str(cfg.state_dtype).removeprefix('torch.')}")

    tr_x, tr_y, te_x, te_y = mnist.splits(80, 40, side=side)
    svc = TMService(
        cfg, init_state(cfg, device=dev),
        ServiceConfig(replicas=replicas, buffer_capacity=32, chunk=8,
                      s=params.s_online, T=params.T,
                      seed=list(range(replicas)),
                      policy=AdaptPolicy(analyze_every=16,
                                         rollback_threshold=0.1)),
        eval_x=te_x, eval_y=te_y, device=dev,
    )
    base = svc.offline_train(tr_x, tr_y, n_epochs=epochs)
    print(f"offline baseline accuracy per member: {np.round(base, 3)}")

    # Online phase: labelled traffic streams in; tick drains, analyzes on
    # cadence and applies the §5.3.2 policy per member.
    for i in range(cycles):
        svc.submit_rows(tr_x[i % len(tr_x)], int(tr_y[i % len(tr_y)]))
        report = svc.tick()
        if report.accuracy is not None:
            print(f"cycle {i:2d}: trained={report.trained.tolist()} "
                  f"acc={np.round(report.accuracy, 3)} "
                  f"rolled_back={report.rolled_back.tolist()}")

    preds = svc.serve(te_x)                       # [K, B] fleet inference
    acc = (preds == np.asarray(te_y)[None]).mean(axis=1)
    print(f"served accuracy per member: {np.round(acc, 3)} "
          f"(rollbacks: {svc.rollbacks.tolist()}, "
          f"dropped: {svc.dropped.tolist()})")
    assert float(acc.min()) > 0.3, "service failed to learn the workload"
    return {"base": base, "served": acc}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=14,
                    help="raster width (28 = full MNIST scale)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    return run(side=a.side, replicas=a.replicas, epochs=a.epochs,
               cycles=a.cycles, device=a.device)


if __name__ == "__main__":
    main()
