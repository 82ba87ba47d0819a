"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
(``repro/launch/dryrun.py``).

* ``policy_for`` equals the reference's ``_policy_for`` for every arch x
  shape (the reference's module sets ``XLA_FLAGS`` when imported, so it
  runs in a subprocess);
* ``make_production_mesh`` builds the reference's (16, 16) and (2, 16,
  16) meshes over a fake world of 256 and 512 ranks, and refuses a world
  of another size;
* a smoke cell of each kind (train, prefill, decode) of three configs on
  a fake (4, 2) world: rank 0's argument bytes equal the sum of the local
  shards that ``param_/batch_/cache_shardings`` imply, and the
  reference's ``compiled.memory_analysis().argument_size_in_bytes`` on 8
  forced host devices (a mesh of Auto axes: jax 0.9's ``make_mesh``
  gives Explicit ones, on which the reference's cells raise, ROADMAP
  queue 3; a training cell that raises even so is recorded); each cell
  records FLOPs, traffic and collectives;
* a cell that raises is written with ``"status": "fail"``;
* an olmoe smoke prefill cell needs no more on a fake (pod, data, model)
  = (2, 4, 2) world than on a flat (4, 2) one: at the expert boundary the
  dispatch groups stay over ``pod`` (the routing integers and logits of
  such a mesh are held to the unsharded port on real ranks in
  ``test_torch_lm_mesh_serve.py``, case ``pod``);
* the TM cell's slab equals the unsharded cross-validation engine's rows
  bit for bit.

Everything that starts a fake process group or sets ``XLA_FLAGS`` runs in
a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.tm_iris import CONFIG as TM_SYS
from repro_torch.distributed import sharding as shd
from repro_torch.eval.crossval import CrossValRun
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import layers, stubs, transformer
from repro_torch.models.params import PSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_ARCHS = ["gemma3_1b", "olmoe_1b_7b", "mamba2_780m"]
CELL_SHAPES = {"train": ShapeConfig("t", 32, 8, "train"),
               "prefill": ShapeConfig("p", 32, 8, "prefill"),
               "decode": ShapeConfig("d", 64, 8, "decode")}


def _run(script: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, *args],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


REF_POLICIES = textwrap.dedent("""\
    import json
    from repro import configs
    from repro.configs.base import SHAPES
    from repro.launch import dryrun
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for name, shape in SHAPES.items():
            p = dryrun._policy_for(cfg, shape)
            out[f"{arch}/{name}"] = {
                "rules": {str(k): v for k, v in p.rules.items()},
                "fsdp": p.fsdp, "fsdp_axes": list(p.fsdp_axes),
                "data_axes": list(p.data_axes), "seq_axis": p.seq_axis}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_policies():
    return _run(REF_POLICIES)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_policy_for_matches_reference(arch, shape, ref_policies):
    p = shd.policy_for(configs.get_config(arch), SHAPES[shape])
    want = ref_policies[f"{arch}/{shape}"]
    assert {str(k): v for k, v in p.rules.items()} == want["rules"]
    assert p.fsdp == want["fsdp"] and p.seq_axis == want["seq_axis"]
    assert list(p.fsdp_axes) == want["fsdp_axes"]
    assert list(p.data_axes) == want["data_axes"]


FAKE = textwrap.dedent("""\
    import json, os, sys, tempfile
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankMesh, make_production_mesh
    out = {"meshes": {}}
    for n, multi in ((256, False), (512, True)):
        with dryrun.fake_world(n):
            m = make_production_mesh(multi_pod=multi, device="meta")
            out["meshes"][str(n)] = [list(m.axis_names),
                                     list(m.shape.values()),
                                     list(m.coordinate)]
            try:
                make_production_mesh(multi_pod=not multi, device="meta")
                out["meshes"][str(n)].append("no error")
            except ValueError as e:
                out["meshes"][str(n)].append("ValueError")
    shapes = {"train": ShapeConfig("t", 32, 8, "train"),
              "prefill": ShapeConfig("p", 32, 8, "prefill"),
              "decode": ShapeConfig("d", 64, 8, "decode")}
    out["cells"] = {}
    with dryrun.fake_world(8):
        mesh = RankMesh((4, 2), ("data", "model"), device="meta")
        for arch in sys.argv[1].split(","):
            cfg = configs.get_smoke_config(arch)
            for kind, shape in shapes.items():
                got = dryrun.trace_cell(cfg, shape, mesh)
                c = got["counts"]
                out["cells"][f"{arch}/{kind}"] = {
                    "argument_bytes": got["argument_bytes"],
                    "flops": c.flops, "traffic": c.traffic_bytes,
                    "peak": c.peak_bytes, "count_by_op": c.count_by_op,
                    "wire": c.total_wire_bytes}
    # a cell that raises is written as failed
    dryrun.trace_cell = lambda *a: (_ for _ in ()).throw(
        RuntimeError("no trace"))
    with tempfile.TemporaryDirectory() as tmp:
        r = dryrun.run_cell("gemma3-1b", "decode_32k", "single", tmp)
        on_disk = json.load(open(os.path.join(
            tmp, "gemma3-1b__decode_32k__single.json")))
    out["fail"] = [r["status"], r["error"], on_disk["status"]]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake():
    return _run(FAKE, ",".join(CELL_ARCHS))


def test_production_meshes_over_fake_worlds(fake):
    m = fake["meshes"]
    assert m["256"][:3] == [["data", "model"], [16, 16], [0, 0]]
    assert m["512"][:3] == [["pod", "data", "model"], [2, 16, 16],
                            [0, 0, 0]]
    # the world must be the mesh's size
    assert m["256"][3] == m["512"][3] == "ValueError"


REF_ARGS = textwrap.dedent("""\
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro import configs
    from repro.configs.base import ShapeConfig
    from repro.distributed import autoshard
    from repro.launch.dryrun import build_cell
    # Auto axes: on make_mesh's default Explicit ones every cell raises
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shapes = {"train": ShapeConfig("t", 32, 8, "train"),
              "prefill": ShapeConfig("p", 32, 8, "prefill"),
              "decode": ShapeConfig("d", 64, 8, "decode")}
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = configs.get_smoke_config(arch)
        for kind, shape in shapes.items():
            axis = "model" if kind == "train" else "data"
            try:
                with mesh, autoshard.use(mesh, moe_expert_axis=axis):
                    fn, args = build_cell(cfg, shape, mesh)
                    mem = fn.lower(*args).compile().memory_analysis()
                out[f"{arch}/{kind}"] = int(mem.argument_size_in_bytes)
            except Exception as e:
                out[f"{arch}/{kind}"] = f"{type(e).__name__}: {e}"[:300]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_args():
    return _run(REF_ARGS, ",".join(CELL_ARCHS))


def _local_bytes(structs, shardings) -> int:
    """The bytes of each leaf's local shard under its sharding on the
    (4, 2) mesh (every sharded dim divided by its axes' sizes)."""
    total = 0
    for s, sh in zip(_leaves(structs), _leaves(shardings)):
        n = 1
        for d, size in enumerate(s.shape):
            entry = sh.spec[d] if d < len(sh.spec) else None
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                size //= sh.mesh.shape[a]
            n *= size
        total += n * s.dtype.itemsize
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k]))
        return out
    return [tree]


def _implied_bytes(arch: str, kind: str) -> int:
    cfg = configs.get_smoke_config(arch)
    shape = CELL_SHAPES[kind]
    mesh = abstract_mesh((4, 2), ("data", "model"))
    policy = shd.policy_for(cfg, shape)
    specs = transformer.model_specs(cfg)
    train = kind == "train"
    dt = layers._DTYPES[cfg.param_dtype if train else cfg.compute_dtype]
    pstructs = shd._map_structs(lambda s: s, _structs(specs, dt))
    psh = shd.param_shardings(specs, mesh, policy)
    total = _local_bytes(pstructs, psh)
    batch = stubs.input_specs(cfg, shape)
    if train:
        mdt = layers._DTYPES[cfg.adam_dtype]
        # mu, nu and the int32 step
        total += 2 * _local_bytes(_structs(specs, mdt), psh) + 4
    if kind == "decode":
        cache = batch.pop("cache")
        total += _local_bytes(cache, shd.cache_shardings(cache, mesh,
                                                          policy))
        batch.pop("pos")
        total += 4 if dryrun.reads_pos(cfg) else 0
    total += _local_bytes(batch, shd.batch_shardings(batch, mesh, policy))
    return total


def _structs(specs, dtype):
    from repro_torch.models.params import ShapeDtype

    if isinstance(specs, PSpec):
        return ShapeDtype(specs.shape, dtype)
    return {k: _structs(v, dtype) for k, v in specs.items()}


@pytest.mark.parametrize("arch", CELL_ARCHS)
@pytest.mark.parametrize("kind", list(CELL_SHAPES))
def test_cell_argument_bytes(arch, kind, fake, ref_args, record_property):
    got = fake["cells"][f"{arch}/{kind}"]
    assert got["argument_bytes"] == _implied_bytes(arch, kind)
    assert got["flops"] > 0 and got["traffic"] > 0 and got["peak"] > 0
    assert got["count_by_op"], "a sharded cell runs collectives"
    ref = ref_args[f"{arch}/{kind}"]
    if isinstance(ref, str):
        # the reference's cell raised: recorded beside the test (its
        # serving cells must compile)
        record_property("reference_cell_raises", ref)
        assert kind == "train", ref
        return
    assert got["argument_bytes"] == ref, (got["argument_bytes"], ref)


def test_failed_cell_is_written(fake):
    status, error, on_disk = fake["fail"]
    assert status == on_disk == "fail"
    assert "no trace" in error


POD_PEAK = textwrap.dedent("""\
    import json
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankMesh
    cfg = configs.get_smoke_config("olmoe_1b_7b")
    # short rows, many of them: the expert buffers set the peak
    shape = ShapeConfig("p", 32, 64, "prefill")
    out = {}
    for shp, names in (((4, 2), ("data", "model")),
                       ((2, 4, 2), ("pod", "data", "model"))):
        with dryrun.fake_world(int(np.prod(shp))):
            mesh = RankMesh(shp, names, device="meta")
            out[len(shp)] = dryrun.trace_cell(cfg, shape,
                                              mesh)["counts"].peak_bytes
    print(json.dumps(out))
""")


def test_moe_prefill_needs_no_more_on_the_pod_mesh():
    """Serving puts the experts over ``data``; the groups, over pod x data
    before the boundary, keep ``pod`` after it. Before, they went whole
    there, and DTensor gathered every group's buffers [G, E, C, D] on
    each rank to cut the experts (1.55x the flat world's peak here; about
    10x at the production meshes' data = 16)."""
    got = _run(POD_PEAK)
    assert got["3"] <= got["2"], got


def test_all_cells_cover_every_arch_shape_and_the_tm_cell():
    cells = list(dryrun.all_cells(["single", "multi"]))
    want = sum(len(SHAPES) - (0 if configs.get_config(a).supports_long_context
                              else 1) for a in configs.ARCH_IDS)
    assert len(cells) == 2 * (want + 1)
    assert (dryrun.TM_ARCH, dryrun.TM_SHAPE, "multi") in cells
    assert all(s != "long_500k" or configs.get_config(a)
               .supports_long_context for a, s, _ in cells
               if a != dryrun.TM_ARCH)


SMALL_GRID = dict(n_s=2, n_T=2, n_orderings=8, n_offline=6,
                  n_validation=10, n_epochs=2)


@pytest.mark.parametrize("n_slabs", [4, 8])
def test_tm_slab_matches_unsharded_engine(n_slabs):
    """Every slab of a small grid, alone, equals its rows of the
    unsharded sweep bit for bit (8 slabs: a slab shorter than the
    orderings, whose streams are gathered a replica)."""
    cfg = TM_SYS.tm
    s_v, T_v, off, val = dryrun.tm_grid_inputs(cfg, SMALL_GRID, seed=3)
    full = CrossValRun(cfg, device="cpu").sweep(
        off[0], off[1], val[0], val[1], s_v, T_v,
        n_epochs=SMALL_GRID["n_epochs"], seed=0)
    want = full.val_accuracy.reshape(-1).numpy()
    size = want.shape[0] // n_slabs
    for j in range(n_slabs):
        got = dryrun.tm_slab(cfg, s_v, T_v, off, val,
                             n_epochs=SMALL_GRID["n_epochs"],
                             n_slabs=n_slabs, slab=j, device="cpu")
        assert np.array_equal(got.numpy(), want[j * size:(j + 1) * size]), j


def test_tm_cell_record(tmp_path):
    r = dryrun.run_tm_cell("single", str(tmp_path), device="cpu",
                           grid=dict(SMALL_GRID, n_orderings=128))
    assert r["status"] == "ok" and r["replicas_per_device"] == 2
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["collectives"]["total_wire_bytes"] == 0.0
    on_disk = json.loads((tmp_path /
                          "tm-iris__hpsearch_grid__single.json").read_text())
    assert on_disk["replicas"] == 2 * 2 * 128
    assert (tmp_path / "tm-iris__hpsearch_grid__single.ops.json").exists()


def test_tm_cell_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without a card the TM cell raises rather than measure the CPU under
    the card's keys; `run_cell` writes that as a failed cell."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_tm_cell("single", str(tmp_path), grid=SMALL_GRID)
    r = dryrun.run_cell(dryrun.TM_ARCH, dryrun.TM_SHAPE, "single",
                        str(tmp_path))
    assert r["status"] == "fail" and "CUDA" in r["error"]
    on_disk = json.loads((tmp_path /
                          "tm-iris__hpsearch_grid__single.json").read_text())
    assert on_disk["status"] == "fail" and on_disk["device"] == "cuda"
