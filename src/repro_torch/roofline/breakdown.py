"""Per-cell hotspot breakdown from the dry run's op table (the port's
counterpart of the reference's ``roofline/breakdown.py``, which reads a
cell's HLO).

Usage: python -m repro_torch.roofline.breakdown <cell>.ops.json [top]
Prints the top ops and result shapes by traffic, the collectives by wire
bytes, and the totals.
"""
from __future__ import annotations

import json
import sys


def breakdown(path: str, top: int = 14) -> None:
    with open(path) as f:
        table = json.load(f)
    print("== traffic hotspots (bytes, every call counted) ==")
    for h in table["hot"][:top]:
        print(f"{h['bytes'] / 1e9:9.2f} GB  {h['op']:34s} {h['shape']}")
    print("== ops by traffic ==")
    for op, v in list(table["ops"].items())[:top]:
        print(f"{v['bytes'] / 1e9:9.2f} GB  {op:34s} x{v['count']:<7d} "
              f"{v['flops']:.3e} FLOPs")
    print("== collectives (wire bytes) ==")
    coll = sorted(table["collectives"].items(),
                  key=lambda kv: -kv[1]["wire_bytes"])
    for op, v in coll[:top]:
        print(f"{v['wire_bytes'] / 1e9:9.2f} GB  {op:18s} x{v['count']:<6d} "
              f"result {v['bytes'] / 1e9:.2f} GB")
    flops = sum(v["flops"] for v in table["ops"].values())
    traffic = sum(v["bytes"] for v in table["ops"].values())
    wire = sum(v["wire_bytes"] for v in table["collectives"].values())
    print(f"== totals: flops={flops:.3e} traffic={traffic / 1e9:.1f}GB "
          f"wire={wire / 1e9:.2f}GB ==")


if __name__ == "__main__":
    breakdown(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 14)
