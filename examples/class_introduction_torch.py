"""Use case §5.2 on the PyTorch/CUDA port: a class the machine has never
seen appears at runtime.

Class 0 is filtered from every set (the over-provisioned class slot stays
gated); after 5 online cycles the filter opens and the class-mask port
enables the slot — no rebuild, mirroring the FPGA's no-re-synthesis
over-provisioning. With online learning the accuracy dips then recovers;
with it disabled the system stays degraded.

    python examples/class_introduction_torch.py [--device cpu]

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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)

    intro = 5
    with_online, _, _, _ = usecases.run_schedule(
        mgr.make_schedule(online_s=1.0, filtered_class=0,
                          introduce_at_cycle=intro),
        n_orderings=12, offline_limit=None, device=dev,
    )
    frozen, _, _, _ = usecases.run_schedule(
        mgr.make_schedule(online_s=1.0, filtered_class=0,
                          introduce_at_cycle=intro, online_enabled=False),
        n_orderings=12, offline_limit=None, device=dev,
    )
    print("validation-set accuracy (class 0 introduced after cycle 5):")
    print("cycle   online-learning   frozen")
    for i in range(len(with_online)):
        mark = "  <-- class 0 introduced" if i == intro + 1 else ""
        print(f"{i:3d}       {with_online[i,1]:.3f}          "
              f"{frozen[i,1]:.3f}{mark}")
    print(f"\nfinal gap (online - frozen): "
          f"{with_online[-1,1] - frozen[-1,1]:+.3f}")
    return {"online": with_online, "frozen": frozen}


if __name__ == "__main__":
    main()
