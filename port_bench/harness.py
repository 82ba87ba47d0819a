"""The harness's common parts: the benchmark file and the names in it,
the record of one run, the profiler's trace, and the result line.

Everything that belongs to one configuration, traffic mix, driver or
metric lives in a file of its own that the harness finds by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the file the configuration entry names),
* ``traffic/<traffic>.json`` (its ``driver`` and parameters),
* ``drivers/<driver>.py`` (``run(run)`` fills a :class:`Run`),
* ``metrics/<name>.py`` and ``layers/<name>.py`` (``read(run)``: the
  end-to-end and per-layer metrics; ``None`` when there is nothing to
  read, and the metric is then left out of the line).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    """The workload entry ``name`` with its configuration entry and the
    parsed configuration and traffic files."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return dict(workload=w, config_entry=conf, config=config,
                traffic=traffic)


def metrics_of(bench: dict, name: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that cell
    ``name`` reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by file name (a
    name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Span:
    """A host interval (``perf_counter`` seconds) of one call into a
    layer: its work (learning steps, points) and whether the profiler
    traced it."""

    t0: float
    t1: float
    steps: int = 0
    work: int = 0
    profiled: bool = False


@dataclasses.dataclass
class Run:
    """Everything one run measured, for the metric readers."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    t_start: float                       # perf_counter at process start
    control: Optional[str] = None
    setup_s: Optional[float] = None
    window: Optional[tuple] = None       # (t0, t1) perf_counter
    spans: dict = dataclasses.field(default_factory=dict)
    serve_latency_ms: list = dataclasses.field(default_factory=list)
    serve_call_ms: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)
    shapes: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    profile: Optional[dict] = None
    # perf_counter and time_ns read together: host spans on the
    # profiler's clock
    clock: tuple = dataclasses.field(
        default_factory=lambda: (time.perf_counter(), time.time_ns()))

    def span(self, name: str, t0: float, t1: float, **kw) -> Span:
        sp = Span(t0, t1, **kw)
        self.spans.setdefault(name, []).append(sp)
        return sp

    def wall_ns(self, t: float) -> int:
        p0, w0 = self.clock
        return w0 + int(round((t - p0) * 1e9))

    def check(self, name: str, value, limit) -> None:
        """A number compared, beside its limit (value <= limit holds)."""
        self.checks[name] = (value, limit)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and v <= lim for v, lim in self.checks.values())


# ---------------------------------------------------------------------------
# The profiler's trace: device kernels and copies, and the host's launches
# ---------------------------------------------------------------------------


def start_profile(run: Run, t: float):
    """Start a CUDA-activity profiler; returns it. Only the device's
    activity and the runtime's launch calls are traced (no operator
    events), which keeps the trace small and the window close to an
    untraced one."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    run.profile = dict(t0=time.perf_counter())
    return prof


def stop_profile(run: Run, prof) -> None:
    """Stop the profiler (after a device sync) and keep its events as
    plain tuples in ``run.profile``."""
    import torch
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof.stop()
    t_parse = time.perf_counter()
    kernels, copies, launch_at = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            rec = (name, e.start_ns(), e.duration_ns(), e.correlation_id())
            (copies if name.startswith(("Memcpy", "Memset")) else
             kernels).append(rec)
        elif "Launch" in name:
            launch_at[e.correlation_id()] = e.start_ns()
    run.profile = dict(kernels=kernels, copies=copies, launch_at=launch_at,
                       w0=run.wall_ns(run.profile["t0"]), w1=run.wall_ns(t1))
    run.info["profile_parse_s"] = time.perf_counter() - t_parse


def _union(intervals, lo: int, hi: int) -> int:
    """Total length of the union of (start, end) intervals within
    [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_window(run: Run) -> Optional[tuple[float, float]]:
    """(seconds some operation ran on the device, seconds traced) over
    the profiled sub-window, or None without a trace."""
    p = run.profile
    if not p or not (p["kernels"] or p["copies"]):
        return None
    iv = [(s, s + d) for _, s, d, _ in p["kernels"] + p["copies"]]
    return _union(iv, p["w0"], p["w1"]) / 1e9, (p["w1"] - p["w0"]) / 1e9


def kernel_time(run: Run, patterns) -> Optional[tuple[float, int]]:
    """(device seconds, calls) of the traced kernels whose names hold
    any of ``patterns``; None when none ran."""
    p = run.profile
    if not p:
        return None
    hits = [d for name, _, d, _ in p["kernels"]
            if any(q in name for q in patterns)]
    if not hits:
        return None
    return sum(hits) / 1e9, len(hits)


def profiled_spans(run: Run, name: str) -> list[Span]:
    return [sp for sp in run.spans.get(name, []) if sp.profiled]


def launches_in(run: Run, name: str) -> Optional[tuple[int, int]]:
    """(kernels launched inside the profiled ``name`` spans, learning
    steps in them). A kernel counts by its launch call's time on the
    host (by its own start where the trace has no launch call)."""
    p = run.profile
    spans = profiled_spans(run, name)
    if not p or not spans:
        return None
    iv = sorted((run.wall_ns(sp.t0), run.wall_ns(sp.t1)) for sp in spans)
    n = 0
    for _, start, _, corr in p["kernels"]:
        t = p["launch_at"].get(corr, start)
        if any(a <= t <= b for a, b in iv):
            n += 1
    return n, sum(sp.steps for sp in spans)


_WRAPPERS = {"vectorized_elementwise_kernel", "elementwise_kernel",
             "unrolled_elementwise_kernel", "AUnaryFunctor", "BUnaryFunctor",
             "gpu_kernel_impl", "gpu_kernel_impl_nocast", "memory"}


def short_name(name: str) -> str:
    """A device operation's name without its template arguments: the
    kernel's own name, and for PyTorch's element-wise wrappers the
    operation they run, as ``elementwise_kernel[CUDAFunctor_add]``."""
    head = re.split(r"[<(]", name.replace("void ", "", 1).replace(
        "(anonymous namespace)::", ""), maxsplit=1)[0].strip()
    head = head.split("::")[-1] or name[:64]
    inner = [t for t in re.findall(r"at::native::(\w+)", name)
             if t not in _WRAPPERS and t != head]
    return f"{head}[{inner[0]}]" if inner else head


def breakdown(run: Run) -> Optional[dict]:
    """The traced sub-window's ten costliest device operations by name,
    and its ten longest idle gaps, each named by the host span that was
    open at its middle."""
    p = run.profile
    if not p:
        return None
    by_name: dict = {}
    for name, _, d, _ in p["kernels"] + p["copies"]:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    iv = sorted((s, s + d) for _, s, d, _ in p["kernels"] + p["copies"])
    gaps, edge = [], p["w0"]
    for s, e in iv:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if p["w1"] > edge:
        gaps.append((edge, p["w1"]))
    host = sorted((run.wall_ns(sp.t0), run.wall_ns(sp.t1), name)
                  for name, sps in run.spans.items() for sp in sps)

    def label(a: int, b: int) -> str:
        mid = (a + b) // 2
        open_ = [n for s, e, n in host if s <= mid <= e]
        return "+".join(sorted(set(open_))) or "host outside the spans"

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, d / 1e9] for n, d in ops],
            "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in gaps]}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


def device_info(run: Run) -> dict:
    import torch
    dev = torch.device(run.device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace:
        bw = busy_window(run)
        if bw is not None:
            info["busy_s"], info["window_s"] = bw
    return info


def result_line(run: Run, metrics: dict) -> dict:
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": device_info(run)}
    if run.trace:
        bd = breakdown(run)
        if bd is not None:
            out["breakdown"] = bd
    # the numbers compared, each beside its limit, under a key of their
    # own that comes last (also the last lines on standard error)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def print_checks(run: Run, stream=None) -> None:
    stream = stream or sys.stderr
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v} (limit {lim})", file=stream)
