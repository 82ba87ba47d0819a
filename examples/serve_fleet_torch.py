"""TMService end to end on the PyTorch/CUDA port: a serving fleet
surviving label drift (§5.3.2).

One fleet-native surface drives the paper's whole Fig-3 story at K = 4:

1. offline-train every member on clean iris rows (one replicated plane
   per datapoint),
2. serve + adapt online via queue-based batch ingress (``submit_rows``
   stages traffic host-side; ``tick`` drains, analyzes on cadence),
3. poison two members' label streams (drift) — their accuracy collapses,
   the §5.3.2 policy rolls THEM back to their known-good banks while the
   clean members keep learning untouched.

Every member runs under its own (s, T) via the runtime's per-replica
hyperparameter ports.

    python examples/serve_fleet_torch.py [--replicas 4] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core import TMConfig, init_state
from repro_torch.core.tm import resolve_device
from repro_torch.data import iris
from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    K = args.replicas
    dev = resolve_device(args.device)

    cfg = TMConfig(n_features=16, max_classes=3, max_clauses=16, n_states=50)
    xs, ys = iris.load()
    svc = TMService(
        cfg, init_state(cfg, device=dev),
        ServiceConfig(
            replicas=K, buffer_capacity=32, chunk=8,
            # per-replica hyperparameter ports: each member its own (s, T)
            s=np.linspace(1.375, 1.8, K).tolist(),
            T=[15] * K,
            policy=AdaptPolicy(analyze_every=8, rollback_threshold=0.08),
            seed=list(range(K)),
        ),
        eval_x=xs[100:], eval_y=ys[100:], device=dev,
    )

    def fmt(v):
        return "[" + " ".join(f"{float(a):.3f}" for a in v) + "]"

    base = svc.offline_train(xs[:80], ys[:80], n_epochs=10)
    print(f"offline phase, per-replica eval accuracy: {fmt(base)}")
    print(f"serving a probe batch: preds[K, B] = {svc.serve(xs[:3]).shape}\n")

    # Online phase: members K//2.. see label drift (adversarial relabels).
    drifted = np.arange(K) >= K // 2
    print("cycle  accuracies (* = rollback fired)   rollbacks")
    for i in range(args.cycles):
        j = 80 + (i % 20)
        y_clean = np.full(K, int(ys[j]), dtype=np.int32)
        y_drift = np.where(drifted, (y_clean + 1) % 3, y_clean)
        svc.submit_rows(np.asarray(xs[j]), y_drift.astype(np.int32))
        report = svc.tick()
        if report.accuracy is not None:
            mark = "*" if report.rolled_back.any() else " "
            print(f"{i:5d}  {fmt(report.accuracy)}{mark}"
                  f"  {svc.rollbacks.tolist()}")

    print(f"\nper-replica rollbacks: {svc.rollbacks.tolist()} "
          f"(drifted members: {np.nonzero(drifted)[0].tolist()})")
    print(f"datapoints lost to backpressure: {svc.lost.tolist()}")
    print(f"ingress device dispatches: {svc.router.flushes} "
          f"for {int(svc.steps.sum())} consumed datapoints")
    final = svc.analyze()
    print(f"final eval accuracy:  {fmt(final)}")
    if svc.rollbacks[drifted].sum() > 0 and (svc.rollbacks[~drifted] == 0).all():
        print("rollbacks hit only drifted members; clean members never "
              "rolled back — the §5.3.2 policy isolated the drift.")
    return {"base": base, "final": final, "rollbacks": svc.rollbacks.copy(),
            "drifted": drifted}


if __name__ == "__main__":
    main()
