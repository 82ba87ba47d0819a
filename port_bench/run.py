"""Run one cell of the benchmark on the card and print its result line.

    python port_bench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1> [--control bf16]

From the root of a checkout. The cell's configuration, traffic mix and
driver come from ``BENCHMARK.json`` and the files it names; with
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the profiler's breakdown.
``--control bf16`` puts the plain reference, with its uniform draws
rounded to bfloat16, in the system's place for the correctness check
(its ``correct`` must read false).

Without a CUDA card (or with fewer than the cell asks for) it exits 2 and
prints no result; it never falls back to the CPU. It exits 3 if JAX,
flax or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    c = harness.cell(bench, args.workload)
    import torch
    need = int(c["workload"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < need:
        print(f"no result: the cell needs {need} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    run = harness.Run(workload=args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", config=c["config"],
                      traffic=c["traffic"], t_start=T_START,
                      control=args.control)
    line = execute(bench, run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"no result: the run loaded {loaded}", file=sys.stderr)
        return 3
    harness.print_checks(run)
    print(json.dumps(line))
    return 0


def execute(bench: dict, run: "harness.Run") -> dict:
    """Drive the cell and read its metrics; returns the result line."""
    driver = harness.load_module("drivers", run.traffic["driver"])
    driver.run(run)
    section = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_of(bench, run.workload, section):
        kind = "layers" if run.trace else "metrics"
        value = harness.load_module(kind, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for k, v in sorted(run.info.items()):
        print(f"info {k}: {v}", file=sys.stderr)
    return harness.result_line(run, metrics)


if __name__ == "__main__":
    sys.exit(main())
