"""Multi-pod dry run: every (arch x shape x mesh) cell, one step as rank 0
of a fake world, the H100 counterpart of the reference's "lower + compile
every cell" (``repro/launch/dryrun.py``).

The reference lowers each cell with abstract inputs and lets XLA's SPMD
partitioner compile it for the production meshes:

    single-pod: (data=16, model=16)            = 256 devices
    multi-pod:  (pod=2, data=16, model=16)     = 512 devices

The port runs the cell instead. One process joins a ``torch.distributed``
world of 256 or 512 ranks over the ``fake`` backend (every collective
returns at once), builds the production mesh as a ``RankMesh``
(:func:`~repro_torch.launch.mesh.make_production_mesh`) with its tensors
on the ``meta`` device (shapes and dtypes, no memory: what
``FakeTensorMode`` keeps under its fake tensors; under that mode itself
DTensor's offset arithmetic, which runs on tensors, turns
data-dependent and raises), and calls the cell's step as rank 0:
parameters, optimizer state, batch and cache are DTensors laid out by
the rules of :mod:`repro_torch.distributed.sharding` under
``sharding.policy_for``'s policy, and the step runs the same code a real rank
runs. :class:`repro_torch.roofline.counts.Recorder` counts what rank 0
did: its argument bytes, the peak of the bytes the step allocated, its
FLOPs, its traffic bytes and its collectives. These go under the
reference's JSON keys (``memory.argument_size_in_bytes``,
``temp_size_in_bytes``, ``cost.flops``, ``collectives.*``) in
``artifacts/dryrun_torch/``, with an op table a cell (``.ops.json``) in
place of ``.hlo.txt``; :mod:`repro_torch.roofline.model` reads them.

:func:`build_cell` is also what real ranks run for sharded serving and
training (``tests/test_torch_lm_mesh_serve.py``, ``chip_smoke.py`` phase
``lm_mesh_serve``): one code path.

The TM cell (``tm-iris``) is the paper's technique on the production
mesh: the (s x T x orderings) hyper-parameter grid, 16 x 4 x 128 = 8192
TM replicas, 10 epochs on 30-row offline sets, validated on 60 rows, the
replica axis in slabs over the mesh's devices (32 a device at 256).
Nothing crosses devices inside a TM step, so the cell runs one slab for
real (:func:`tm_slab`: the engine's own slab, ``crossval.sweep_slab``,
through its kernels) on the card, and reports that slab's peak (the
card's allocator) and no collectives; without a card the cell fails.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k --mesh multi
  python -m repro_torch.launch.dryrun --all [--mesh both] [--subprocess] [--jobs N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.base import (
    GLOBAL, LOCAL, SHAPES, ModelConfig, ShapeConfig,
)
from repro_torch.distributed import autoshard
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers, stubs, transformer
from repro_torch.models.params import ShapeDtype, tree_map_specs
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as TS

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/dryrun_torch")
TM_ARCH = "tm-iris"
TM_SHAPE = "hpsearch_grid"
# the reference's grid: 16 s x 4 T x 128 orderings, 30 / 60 rows, 10 epochs
TM_GRID = dict(n_s=16, n_T=4, n_orderings=128, n_offline=30,
               n_validation=60, n_epochs=10)

@contextlib.contextmanager
def serving(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The hint mesh a cell runs under: experts over ``model`` for
    training (EP in the TP axis), over ``data`` for serving (the
    reference's ``run_cell``)."""
    axis = "model" if shape.kind == "train" else "data"
    with autoshard.use(mesh, moe_expert_axis=axis):
        yield


def _structs(specs, dtype):
    return tree_map_specs(lambda s: ShapeDtype(s.shape, dtype), specs)


def _zeros(structs, device):
    """Zeros of a ShapeDtype tree (shapes alone on "meta")."""
    return shd._map_structs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
        structs)


def _dtype(name: str) -> torch.dtype:
    return layers._DTYPES[name]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, params=None,
               batch=None, cache=None):
    """(step function, its arguments) for one cell on ``mesh`` (a
    RankMesh), the reference's ``build_cell``: the arguments laid out over
    the mesh as DTensors by the cell's policy, the step run by calling
    ``fn(*args)`` on every rank. ``params`` and ``batch`` (numpy or
    tensors, whole) default to zeros of the cell's shapes; decode takes
    ``cache`` (a cache of DTensors, e.g. a prefill's) or zeros laid out by
    ``cache_shardings``.

    * train: ``train_step`` on a state (parameters in ``param_dtype``,
      AdamW moments in ``adam_dtype``) pinned to ``state_shardings``,
      donated;
    * prefill: ``transformer.prefill`` of a ``seq_len`` prompt, its cache
      built laid out by ``cache_shardings``;
    * decode: ``transformer.decode_step`` on that cache, updated in place
      (the reference donates it).

    Serving deploys ``compute_dtype`` weights (the reference's choice).
    MoE layers dispatch in ``moe_groups(cfg, mesh)`` groups."""
    policy = shd.policy_for(cfg, shape)
    specs = transformer.model_specs(cfg)
    train = shape.kind == "train"
    dev = mesh.device
    p_dtype = _dtype(cfg.param_dtype if train else cfg.compute_dtype)
    p_shard = shd.param_shardings(specs, mesh, policy)
    groups = shd.moe_groups(cfg, mesh)
    if params is None:
        params = _zeros(_structs(specs, p_dtype), dev)
    params = T.map(lambda x: x if autoshard.is_distributed(x) else
                   torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                   else x).to(p_dtype), params)
    in_specs = stubs.input_specs(cfg, shape)

    if train:
        tc = TS.TrainConfig(opt=opt_mod.OptConfig(moment_dtype=cfg.adam_dtype),
                            microbatches=cfg.train_microbatches,
                            moe_num_groups=groups)
        state = shd.distribute(TS.init_state(tc, params),
                               TS.state_shardings(cfg, tc, mesh, policy))
        if batch is None:
            batch = _zeros(in_specs, dev)
        batch = _place_batch(batch, mesh, policy)

        def step(state, batch):
            return TS.train_step(cfg, tc, state, batch, donate=True)

        return step, (state, batch)

    params = shd.distribute(params, p_shard)
    if shape.kind == "prefill":
        if batch is None:
            batch = _zeros(in_specs, dev)
        batch = _place_batch(batch, mesh, policy)
        pc_shard = shd.cache_shardings(
            transformer.cache_struct(cfg, shape.global_batch, shape.seq_len),
            mesh, policy)

        def prefill_fn(params, batch):
            return transformer.prefill(cfg, params, batch, shape.seq_len,
                                       num_groups=groups,
                                       shardings=pc_shard)

        return prefill_fn, (params, batch)

    cache_struct = in_specs.pop("cache")
    if cache is None:
        cache = shd.zeros(cache_struct, shd.cache_shardings(
            cache_struct, mesh, policy))
    if batch is None:
        batch = _zeros({k: v for k, v in in_specs.items() if k != "pos"},
                       dev)
        batch["pos"] = shape.seq_len - 1
    batch = _place_batch(batch, mesh, policy)

    def serve_step(params, batch, cache):
        return transformer.decode_step(cfg, params, batch, cache,
                                       num_groups=groups)

    return serve_step, (params, batch, cache)


def _place_batch(batch: dict, mesh, policy) -> dict:
    """A batch's arrays laid out by ``batch_shardings`` (a Python int such
    as decode's ``pos`` stays as it is)."""
    arrays = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v)
              for k, v in batch.items() if not isinstance(v, int)}
    placed = shd.distribute(arrays, shd.batch_shardings(arrays, mesh, policy))
    return {k: placed.get(k, v) for k, v in batch.items()}


def argument_bytes(cfg: ModelConfig, args) -> int:
    """The bytes rank 0 holds of a cell's arguments: each DTensor's local
    shard, each plain tensor, and 4 bytes for decode's ``pos`` (a Python
    int here, an int32 scalar in the reference) where the model reads it:
    a stack without GLOBAL or LOCAL attention never does, and XLA drops
    an argument the program does not read."""
    total = 0
    for x in T.leaves(args):
        if autoshard.is_distributed(x):
            x = x.to_local()
        if torch.is_tensor(x):
            total += x.numel() * x.element_size()
        elif isinstance(x, int) and not isinstance(x, bool):
            total += 4 if reads_pos(cfg) else 0
    return total


def reads_pos(cfg: ModelConfig) -> bool:
    """Whether a decode step reads its position (rope, the KV write)."""
    return any(k in (GLOBAL, LOCAL) for k in cfg.layer_kinds)


def _arg_tensors(args) -> list:
    return [x for x in T.leaves(args) if torch.is_tensor(x)]


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a ``fake``-backend world of ``n`` ranks
    (every collective returns at once; nothing is sent)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_of(kind: str):
    from repro_torch.launch import mesh as mesh_mod

    if kind.startswith("multi"):
        n_pods = int(kind[5:]) if len(kind) > 5 else 2
        return mesh_mod.make_production_mesh(multi_pod=True, n_pods=n_pods,
                                             device="meta")
    return mesh_mod.make_production_mesh(multi_pod=False, device="meta")


def _world_size(kind: str) -> int:
    if kind.startswith("multi"):
        return 256 * (int(kind[5:]) if len(kind) > 5 else 2)
    return 256


@contextlib.contextmanager
def gpu_alltoall():
    """DTensor's Shard -> Shard moves as the all-to-all a GPU mesh runs
    (``_dtensor::shard_dim_alltoall``), not the all-gather and chunk it
    falls back to on a CPU mesh (gloo has no all-to-all): the dry run's
    mesh is a CPU one over "meta" tensors, and models a deployment on
    GPUs."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)

    mods = [m for m in (_collective_utils, placement_types)
            if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.shard_dim_alltoall = f


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """One step of the cell on ``mesh`` (a RankMesh on "meta", inside a
    world that has it), recorded: {"argument_bytes", "counts" (Counts),
    "build_s", "trace_s"}."""
    from repro_torch.roofline.counts import Recorder

    layers._rope_freqs.cache_clear()
    try:
        with serving(cfg, shape, mesh), gpu_alltoall():
            t0 = time.time()
            fn, args = build_cell(cfg, shape, mesh)
            arg_b = argument_bytes(cfg, args)
            t_build = time.time() - t0
            rec = Recorder()
            rec.exclude(_arg_tensors(args))
            with rec:
                out = fn(*args)
            del out
            t_trace = time.time() - t0 - t_build
    finally:
        layers._rope_freqs.cache_clear()
    return {"argument_bytes": arg_b, "counts": rec.counts(),
            "build_s": t_build, "trace_s": t_trace}


def _stem(arch: str, shape_name: str, mesh_kind: str) -> str:
    return f"{arch.replace('.', '_')}__{shape_name}__{mesh_kind}"


def _write(out_dir: str, stem: str, result: dict, table=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    if table is not None:
        with open(os.path.join(out_dir, stem + ".ops.json"), "w") as f:
            json.dump(table, f, indent=1)
    with open(os.path.join(out_dir, stem + ".json"), "w") as f:
        json.dump(result, f, indent=1)


def _collectives(c) -> dict:
    return {"bytes_by_op": c.bytes_by_op, "count_by_op": c.count_by_op,
            "wire_bytes_by_op": c.wire_bytes_by_op,
            "wire_bytes_by_link": c.wire_bytes_by_link,
            "total_wire_bytes": c.total_wire_bytes}


def _failed(result: dict, e: Exception, t0: float, out_dir: str,
            stem: str) -> dict:
    result.update({"status": "fail", "error": f"{type(e).__name__}: {e}"
                   [:4000], "traceback": traceback.format_exc()[-8000:],
                   "trace_s": round(time.time() - t0, 2)})
    _write(out_dir, stem, result)
    return result


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             save_ops: bool = True) -> dict:
    """Trace one cell (the TM cell: run its slab on the card) and write
    its JSON (and op table); a cell that cannot be traced or run is
    written with ``"status": "fail"`` and the exception."""
    n_dev = _world_size(mesh_kind)
    t0 = time.time()
    if arch in (TM_ARCH, "tm_iris"):
        try:
            return run_tm_cell(mesh_kind, out_dir, save_ops)
        except Exception as e:  # noqa: BLE001 - the cell's record says why
            return _failed({"arch": TM_ARCH, "shape": TM_SHAPE,
                            "mesh": mesh_kind, "n_devices": n_dev,
                            "device": "cuda"}, e, t0, out_dir,
                           f"{TM_ARCH}__{TM_SHAPE}__{mesh_kind}")
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    stem = _stem(arch, shape_name, mesh_kind)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "status": "skip", "reason": None}
    if shape_name == "long_500k" and not cfg.supports_long_context:
        result["reason"] = "pure full-attention arch (DESIGN.md skip table)"
        return result
    try:
        with fake_world(n_dev):
            got = trace_cell(cfg, shape, _mesh_of(mesh_kind))
    except Exception as e:  # noqa: BLE001 - the cell's record says why
        result["n_devices"] = n_dev
        return _failed(result, e, t0, out_dir, stem)
    c = got["counts"]
    result.update({
        "status": "ok",
        "n_devices": n_dev,
        "build_s": round(got["build_s"], 2),
        "trace_s": round(got["trace_s"], 2),
        "memory": {"argument_size_in_bytes": got["argument_bytes"],
                   "temp_size_in_bytes": int(c.peak_bytes)},
        "cost": {"flops": c.flops, "bytes accessed": c.traffic_bytes},
        "collectives": _collectives(c),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    })
    _write(out_dir, stem, result, c.table() if save_ops else None)
    return result


# ---------------------------------------------------------------------------
# The TM cell: one slab of the hyper-parameter grid, run for real
# ---------------------------------------------------------------------------


def tm_grid_inputs(tm_cfg, grid: dict = TM_GRID, seed: int = 0):
    """The grid's s and T values and random offline / validation sets
    ([O, n, f] bool, [O, n] labels), made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    O, f = grid["n_orderings"], tm_cfg.n_features
    n_cls = tm_cfg.max_classes
    s_values = np.linspace(1.0, 8.5, grid["n_s"]).astype(np.float32)
    T_values = (5 * np.arange(1, grid["n_T"] + 1)).astype(np.int32)
    off_x = rng.random((O, grid["n_offline"], f)) < 0.5
    off_y = rng.integers(0, n_cls, (O, grid["n_offline"])).astype(np.int32)
    val_x = rng.random((O, grid["n_validation"], f)) < 0.5
    val_y = rng.integers(0, n_cls, (O, grid["n_validation"])).astype(
        np.int32)
    return s_values, T_values, (off_x, off_y), (val_x, val_y)


def tm_slab(tm_cfg, s_values, T_values, off, val, *, n_epochs: int,
            n_slabs: int, slab: int = 0, seed: int = 0, device="cuda"):
    """Slab ``slab`` of ``n_slabs`` of the (s x T x orderings) sweep, as
    ``CrossValRun(cfg, mesh=...).sweep`` lays it out (the replica axis,
    grid-major and ordering-minor, cut into equal contiguous slabs) and
    runs it (``crossval.sweep_slab``) on that slab's device. Returns its
    validation accuracies [hi - lo] (rows lo..hi-1 of the sweep's
    flattened ``val_accuracy``), bitwise those of the whole sweep."""
    from repro_torch import random as rnd
    from repro_torch.core import tm as tm_mod
    from repro_torch.eval import crossval as cv

    dev = tm_mod.resolve_device(device)
    O = off[0].shape[0]
    s_rep, T_rep = cv.grid_layout(s_values, T_values, O)
    R = s_rep.shape[0]
    if R % n_slabs:
        raise ValueError(f"{R} replicas do not split into {n_slabs} slabs")
    lo, hi = slab * (R // n_slabs), (slab + 1) * (R // n_slabs)
    keys = rnd.split(rnd.PRNGKey(seed, dev), O)
    return cv.sweep_slab(tm_cfg, (off[0], off[1], None), val, keys,
                         s_rep[lo:hi], T_rep[lo:hi], lo, hi,
                         n_epochs=n_epochs, device=dev)


def run_tm_cell(mesh_kind: str, out_dir: str, save_ops: bool = True,
                device="cuda", grid: dict = TM_GRID) -> dict:
    """Slab 0 of the TM grid over the production mesh's devices, run on
    ``device`` (the card unless the caller names another; without a card
    asking for it raises). Its peak is the cell's per-device memory: on
    the card its allocator's peak, on the CPU the recorder's live bytes
    (the record names the device). No collective runs."""
    from repro_torch.configs.tm_iris import CONFIG as TM_SYS
    from repro_torch.core import tm as tm_mod
    from repro_torch.roofline.counts import Recorder

    dev = tm_mod.resolve_device(device)
    cfg = TM_SYS.tm
    n_dev = _world_size(mesh_kind)
    replicas = grid["n_s"] * grid["n_T"] * grid["n_orderings"]
    s_v, T_v, off, val = tm_grid_inputs(cfg, grid)
    cuda = dev.type == "cuda"
    # the recorder slows a real run about 10x, so the card runs without it
    rec = Recorder()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    with contextlib.nullcontext() if cuda else rec:
        acc = tm_slab(cfg, s_v, T_v, off, val, n_epochs=grid["n_epochs"],
                      n_slabs=n_dev, device=dev)
        acc = acc.cpu()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else rec.peak
    c = rec.counts()
    per = replicas // n_dev
    result = {
        "arch": TM_ARCH, "shape": TM_SHAPE, "mesh": mesh_kind,
        "status": "ok", "n_devices": n_dev, "device": str(dev),
        "replicas": replicas, "replicas_per_device": per,
        "slab_s": round(wall, 3),
        "memory": {"argument_size_in_bytes": 0,
                   "temp_size_in_bytes": int(peak)},
        "cost": ({} if cuda else {"flops": c.flops,
                                  "bytes accessed": c.traffic_bytes}),
        "collectives": {"count_by_op": {}, "total_wire_bytes": 0.0},
        "param_count": 0, "active_param_count": 0,
        "slab_accuracy_mean": float(acc.float().mean()),
    }
    _write(out_dir, f"{TM_ARCH}__{TM_SHAPE}__{mesh_kind}", result,
           c.table() if save_ops and not cuda else None)
    return result


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def all_cells(mesh_kinds):
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not cfg.supports_long_context:
                continue
            for mk in mesh_kinds:
                yield cfg.arch_id, shape_name, mk
    for mk in mesh_kinds:
        yield TM_ARCH, TM_SHAPE, mk


def _run_one(arch, shape_name, mk, out, no_ops) -> tuple[bool, str]:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape_name, "--mesh", mk, "--out", out] + (
               ["--no-ops"] if no_ops else [])
    r = subprocess.run(cmd, capture_output=True, text=True)
    ok = r.returncode == 0
    return ok, "" if ok else (r.stdout[-2000:] + r.stderr[-2000:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [TM_SHAPE])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "multi4", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process (bounded memory)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once with --subprocess")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--no-ops", action="store_true",
                    help="write no op table (the reference's --no-hlo)")
    args = ap.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = os.path.abspath(args.out)

    if args.all:
        cells = list(all_cells(mesh_kinds))
        todo = []
        for i, (arch, shape_name, mk) in enumerate(cells):
            stem = _stem(arch, shape_name, mk)
            if os.path.exists(os.path.join(out, stem + ".json")):
                print(f"[{i + 1}/{len(cells)}] {stem}: cached", flush=True)
            else:
                todo.append((i, arch, shape_name, mk))
        failures = 0

        def one(item):
            i, arch, shape_name, mk = item
            stem = _stem(arch, shape_name, mk)
            t0 = time.time()
            if args.subprocess:
                ok, why = _run_one(arch, shape_name, mk, out, args.no_ops)
            else:
                res = run_cell(arch, shape_name, mk, out,
                               save_ops=not args.no_ops)
                ok, why = res["status"] != "fail", res.get("error", "")
            print(f"[{i + 1}/{len(cells)}] {stem}: "
                  f"{'ok' if ok else 'FAIL'} ({time.time() - t0:.0f}s)"
                  + ("" if ok else "\n" + why), flush=True)
            return ok

        jobs = args.jobs if args.subprocess else 1
        with ThreadPoolExecutor(max(jobs, 1)) as pool:
            failures = sum(not ok for ok in pool.map(one, todo))
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    status = 0
    for mk in mesh_kinds:
        res = run_cell(args.arch, args.shape, mk, out,
                       save_ops=not args.no_ops)
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("collectives", "traceback")},
                         indent=1))
        if res["status"] == "ok":
            print("collective wire bytes:",
                  res["collectives"]["total_wire_bytes"])
        elif res["status"] == "fail":
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
