"""Quickstart on the PyTorch/CUDA port: the paper's core loop on iris
(§5.1 / Fig 4).

Offline-train a Tsetlin Machine on 20 labelled datapoints, then keep
learning online while the accuracy-analysis block tracks all three sets —
every cross-validation ordering advances in one replica-first plane per
datapoint (``repro_torch.eval.usecases``). Then the same machine goes live
behind ``TMService``, the fleet-native serving surface (a single machine
is just K = 1): labelled traffic through the queue-based batch ingress,
``tick`` interleaving online training with periodic accuracy analysis.

    python examples/quickstart_torch.py [--orderings 12] [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.core import manager as mgr
from repro_torch.core.tm import resolve_device
from repro_torch.eval import usecases


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--orderings", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    schedule = mgr.make_schedule(online_s=1.0)
    curve, activity, wall, O = usecases.run_schedule(
        schedule, n_orderings=args.orderings, device=dev
    )
    print(f"{O} cross-validation orderings in {wall:.1f}s "
          f"(one replica-first plane per datapoint)\n")
    print("cycle  offline  validation  online")
    for i, (a, b, c) in enumerate(curve):
        tag = "offline-trained" if i == 0 else f"online cycle {i}"
        print(f"{tag:18s} {a:.3f}    {b:.3f}     {c:.3f}")
    gains = curve[-1] - curve[0]
    print(f"\nonline-learning gains: offline {gains[0]:+.3f}  "
          f"validation {gains[1]:+.3f}  online {gains[2]:+.3f}")
    print(f"mean TA-update activity (clock-gating analogue): "
          f"{activity.mean():.4f}")

    # -- the same machine as a live service (TMService, K = 1) --------------
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs, ys = iris.load()
    svc = TMService(
        usecases.CFG, init_state(usecases.CFG, device=dev),
        ServiceConfig(replicas=1, buffer_capacity=32, chunk=8,
                      s=1.0, T=15,
                      policy=AdaptPolicy(analyze_every=16)),
        eval_x=xs[100:], eval_y=ys[100:], device=dev,
    )
    base = svc.offline_train(xs[:20], ys[:20], n_epochs=10)
    print(f"\nTMService (K=1): offline eval accuracy {float(base[0]):.3f}")
    accs = []
    for i in range(32):                      # labelled traffic -> batch ingress
        svc.submit(0, xs[20 + i], int(ys[20 + i]))
        report = svc.tick()                  # drain + cadence + analysis
        if report.accuracy is not None:
            accs.append(float(report.accuracy[0]))
            print(f"  tick {i}: online-adapted eval accuracy {accs[-1]:.3f}")
    preds = svc.serve(xs[:5])[0]
    print(f"  served predictions for a probe batch: {preds.tolist()}")
    return {"curve": curve, "activity": activity, "base": base,
            "service_accuracy": accs, "preds": preds}


if __name__ == "__main__":
    main()
