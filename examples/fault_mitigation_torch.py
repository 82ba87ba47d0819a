"""Use case §5.3 on the PyTorch/CUDA port: stuck-at faults injected into
the running machine.

20% of TAs are forced stuck-at-0 through the fault controller's AND/OR
masks after 5 online cycles (no rebuild — the masks are runtime state).
Online learning re-trains "around" the faulty automata; the frozen system
cannot.

    python examples/fault_mitigation_torch.py [--device cpu]

It runs on the CUDA card unless ``--device`` names another device.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

from repro_torch.core import faults as faults_mod
from repro_torch.core import manager as mgr
from repro_torch.core.tm import resolve_device
from repro_torch.eval import usecases


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    inject = 5
    masks = faults_mod.even_spread_stuck_at(usecases.CFG, 0.2, 0)

    online, _, _, _ = usecases.run_schedule(
        mgr.make_schedule(online_s=1.0, fault_masks=masks,
                          inject_at_cycle=inject),
        n_orderings=12, device=dev,
    )
    frozen, _, _, _ = usecases.run_schedule(
        mgr.make_schedule(online_s=1.0, fault_masks=masks,
                          inject_at_cycle=inject, online_enabled=False),
        n_orderings=12, device=dev,
    )
    print("validation accuracy, 20% stuck-at-0 TAs injected after cycle 5:")
    print("cycle   online-learning   frozen")
    for i in range(len(online)):
        mark = "  <-- faults injected" if i == inject + 1 else ""
        print(f"{i:3d}       {online[i,1]:.3f}          "
              f"{frozen[i,1]:.3f}{mark}")
    print(f"\nfinal gap (online - frozen): "
          f"{online[-1,1] - frozen[-1,1]:+.3f}")
    return {"online": online, "frozen": frozen}


if __name__ == "__main__":
    main()
