"""Three-term roofline model over the dry run's records, for the NVIDIA
H100 SXM (the reference's ``roofline/model.py`` on TPU v5e constants).

Terms (per device), from the H100 datasheet
(https://www.nvidia.com/en-us/data-center/h100/, H100 SXM column):
  compute    = FLOPs / 989.4e12          (dense BF16 tensor-core peak)
  memory     = bytes / 3.35e12           (HBM3 bandwidth)
  collective = NVLink wire bytes / 450e9 (NVLink 4: 900 GB/s, 450e9 B/s
               a direction) + network wire bytes / 50e9

A collective whose group spans more than the 8 GPUs of one NVLink node
takes the inter-node network. Its rate is an ASSUMPTION, not a datasheet
figure: one 400 Gb/s NIC a GPU (ConnectX-7 / InfiniBand NDR, as in a
DGX H100), 50e9 B/s a direction.

These are spec-sheet estimates of a step's time, not measurements. The
FLOPs, traffic and wire bytes come from what rank 0 ran in the dry run
(:mod:`repro_torch.roofline.counts`: every aten op's local FLOPs and
operand + result bytes, the collectives' ring wire bytes); MODEL_FLOPS is
the analytic useful compute (6·N·D train / 2·N_active·tokens serve), and
its ratio to the recorded FLOPs exposes replicated or recomputed work.
The traffic counts each op's operands and result once (eager PyTorch
fuses nothing), so it is an upper bound of the HBM bytes a fused program
would move.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import SHAPES

PEAK_FLOPS = 989.4e12    # bf16 dense / GPU (H100 SXM datasheet)
HBM_BW = 3.35e12         # bytes/s / GPU (HBM3, H100 SXM datasheet)
LINK_BW = 450e9          # bytes/s a direction (NVLink 4, datasheet)
NET_BW = 50e9            # bytes/s a direction: an assumed 400 Gb/s NIC
HBM_BYTES = 80 * 2**30   # device memory (H100 SXM 80 GB)


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    fits_80g: bool
    mem_gib: float
    # per-device
    flops: float
    traffic_bytes: float
    wire_bytes: float
    model_flops_device: float
    # seconds (spec-sheet estimates)
    t_compute: float
    t_memory: float
    t_collective: float

    model_bytes_device: float = 0.0  # minimal bytes/step (params + caches)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """useful FLOPs / recorded FLOPs, clamped to [0, 1] (SSM decode
        cells run element-wise ops with no products, so the raw ratio is
        unbounded)."""
        return self.model_flops_device / max(self.flops,
                                             self.model_flops_device, 1.0)

    @property
    def is_decode(self) -> bool:
        return self.shape in ("decode_32k", "long_500k")

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound spent on irreducible work:
        useful-compute time (train / prefill) or useful-bytes time
        (decode, inherently memory-bound) over the dominant term."""
        if self.is_decode:
            t_useful = self.model_bytes_device / HBM_BW
        else:
            t_useful = self.model_flops_device / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / max(t_bound, 1e-30)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def model_bytes(arch: str, shape_name: str, n_devices: int) -> float:
    """Minimal per-device HBM bytes per serve step: bf16 active params read
    once + the KV/state cache read once (+ the one-token write,
    negligible)."""
    from repro_torch.models import transformer

    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind != "decode":
        return 0.0
    params_b = 2.0 * cfg.active_param_count()
    cache = transformer.cache_struct(cfg, shape.global_batch, shape.seq_len)
    cache_b = sum(float(np.prod(l.shape)) * l.dtype.itemsize
                  for l in _leaves(cache))
    return (params_b + cache_b) / n_devices


def model_flops(arch: str, shape_name: str, n_devices: int) -> float:
    """Analytic useful FLOPs per device per step."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def improvement_hint(c: CellRoofline) -> str:
    if c.dominant == "collective":
        return ("cut cross-device bytes: bf16 collectives, fuse/batch "
                "gathers, or reshard to keep the hot loop local")
    if c.dominant == "memory":
        if c.useful_ratio < 0.5:
            return ("moves >2x useful bytes: fuse the offending op chain "
                    "(a kernel) or remove replicated copies")
        return "raise arithmetic intensity: larger microbatch/chunk, fusion"
    if c.useful_ratio < 0.5:
        return "compute is replicated or rematerialised: check shardings/remat"
    return "near compute bound: only kernel-level tensor-core use remains"


def analyze_cell(json_path: str) -> Optional[CellRoofline]:
    with open(json_path) as f:
        r = json.load(f)
    if r.get("status") != "ok":
        return None
    flops = r["cost"].get("flops", 0.0)
    traffic = r["cost"].get("bytes accessed", 0.0)
    coll = r["collectives"]
    links = coll.get("wire_bytes_by_link")
    if links is None:
        links = {"nvlink": 0.0, "network": coll.get("total_wire_bytes", 0.0)}
    mem = r["memory"]
    mem_bytes = mem.get("argument_size_in_bytes", 0) + mem.get(
        "temp_size_in_bytes", 0)
    tm = r["arch"] == "tm-iris"
    mf = 0.0 if tm else model_flops(r["arch"], r["shape"], r["n_devices"])
    mb = 0.0 if tm else model_bytes(r["arch"], r["shape"], r["n_devices"])
    return CellRoofline(
        model_bytes_device=mb,
        arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
        n_devices=r["n_devices"],
        fits_80g=mem_bytes < HBM_BYTES,
        mem_gib=mem_bytes / 2**30,
        flops=flops,
        traffic_bytes=traffic,
        wire_bytes=coll.get("total_wire_bytes", 0.0),
        model_flops_device=mf,
        t_compute=flops / PEAK_FLOPS,
        t_memory=traffic / HBM_BW,
        t_collective=(links.get("nvlink", 0.0) / LINK_BW
                      + links.get("network", 0.0) / NET_BW),
    )


def analyze_dir(art_dir: str) -> list:
    cells = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        if p.endswith(".ops.json"):
            continue
        c = analyze_cell(p)
        if c is not None:
            cells.append(c)
    return cells


def markdown_table(cells: list) -> str:
    hdr = ("| arch | shape | mesh | mem GiB (fits 80G) | compute s | "
           "memory s | collective s | dominant | useful/recorded | "
           "roofline frac | next lever |")
    sep = "|" + "---|" * 11
    rows = [hdr, sep]
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | "
            f"{c.mem_gib:.1f} ({'Y' if c.fits_80g else 'N'}) | "
            f"{c.t_compute:.3e} | {c.t_memory:.3e} | {c.t_collective:.3e} | "
            f"{c.dominant} | {c.useful_ratio:.2f} | "
            f"{c.roofline_fraction:.3f} | {improvement_hint(c)} |"
        )
    return "\n".join(rows)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "../../../artifacts/dryrun_torch"))
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    cells = analyze_dir(os.path.abspath(args.dir))
    print(markdown_table(cells))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(c) for c in cells], f, indent=1)


if __name__ == "__main__":
    main()
