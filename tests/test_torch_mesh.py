"""The port's replica-axis mesh against the JAX package's sharded runs.

The port lays a mesh out over an explicit device list in which a device
may repeat: here four slabs on the CPU (``Mesh(["cpu"] * 4, ("data",))``),
the counterpart of the reference's ``--xla_force_host_platform_device_count
=4``. The JAX side runs on four forced host devices, in one subprocess
shared by the module (XLA fixes its device count at import), and hands its
results back through an ``.npz``. Every case holds the port's sharded run
bit for bit against the port without a mesh and against the JAX package's
sharded run:

* ``Mesh`` / ``make_host_mesh``, ``device_put`` / ``gather`` and the
  ``replica_shardings`` rule (a full-R leaf shards, a D-stream leaf and a
  non-dividing R replicate, ``n_replicas=None`` is a ``TypeError``),
  with the specs the reference gives for the same trees;
* the fleet (``OnlineFleet(mesh=)``): banks, rings, step counters, keys
  and served predictions, also with per-replica budgets that give the
  slabs different loop lengths;
* ``CrossValRun(mesh=).sweep`` at O = 4 over a 2 x 2 grid (slabs of 4:
  every slab reads its streams as they are), over a 2-cell grid (4
  slabs of 2: the gathered-stream path) and over a single cell (R = O,
  slabs of 1), and ``grid_search(mesh=)``;
* ``manager.run_orderings(mesh=)`` (activity within the XLA float mean's
  rounding against the JAX package, bitwise against the port);
* ``TMFleetAdaptManager(mesh=)``: analysis, rollback and history;
* the auto-residency granule: plane widths round up to the mesh's size.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import TMConfig, hpsearch, init_runtime, init_state
from repro_torch.core import manager as t_mgr
from repro_torch.data import blocks, iris
from repro_torch.distributed import sharding as shard_mod
from repro_torch.eval import crossval as t_cv
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.serve import ServiceConfig, TMFleetAdaptManager, TMService
from repro_torch.serve import TMOnlineAdaptConfig
from repro_torch.serve.fleet import OnlineFleet

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = dict(n_features=16, max_classes=3, max_clauses=16, n_states=16)
CFG = TMConfig(**FIELDS)
MESH = Mesh(["cpu"] * 4, ("data",))
K = 8
ACT_RTOL = 2e-6      # XLA's float mean over non-0/1 activities (ROADMAP)

JAX_SCRIPT = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as PS
    assert len(jax.devices()) == 4, jax.devices()

    from repro.core import TMConfig, init_runtime, init_state
    from repro.core import hpsearch, manager as mgr
    from repro.data import blocks, iris
    from repro.distributed import sharding as shard_mod
    from repro.eval.crossval import CrossValRun
    from repro.serve.fleet import OnlineFleet
    from repro.serve.online_adapt import (TMFleetAdaptManager,
                                          TMOnlineAdaptConfig)

    cfg = TMConfig(n_features=16, max_classes=3, max_clauses=16,
                   n_states=16, backend="ref")
    mesh = Mesh(np.array(jax.devices()), ("data",))
    out = {}

    tree = {"full": jax.ShapeDtypeStruct((16, 3, 16, 32), jnp.int8),
            "stream": jax.ShapeDtypeStruct((4, 30, 16), bool),
            "odd": jax.ShapeDtypeStruct((6, 2), jnp.uint32),
            "scalar": jax.ShapeDtypeStruct((), jnp.float32)}
    sh = shard_mod.replica_shardings(tree, mesh, n_replicas=16)
    for k, v in sh.items():
        out["spec_" + k] = np.asarray(v.spec == PS("data"))
    odd = shard_mod.replica_shardings(tree, mesh, n_replicas=6)
    out["spec_odd6"] = np.asarray(odd["odd"].spec == PS("data"))

    xs, ys = iris.load()
    rt = init_runtime(cfg, s=3.0, T=15)
    fleet = OnlineFleet(cfg, init_state(cfg), rt, n_replicas=8,
                        buffer_capacity=16, chunk=4, seed=list(range(8)),
                        mesh=mesh)
    for i in range(12):
        fleet.offer_rows(
            np.stack([xs[(i + 7 * r) % 150] for r in range(8)]),
            np.asarray([int(ys[(i + 7 * r) % 150]) for r in range(8)]))
    out["fleet_trained"] = fleet.drain(np.asarray([1, 2, 3, 4, 9, 12, 0, 5]))
    out["fleet_trained2"] = fleet.drain(6)
    ss = fleet.ss
    out["fleet_ta"] = np.asarray(ss.tm.ta_state)
    out["fleet_head"] = np.asarray(ss.buf.head)
    out["fleet_size"] = np.asarray(ss.buf.size)
    out["fleet_step"] = np.asarray(ss.step)
    out["fleet_keys"] = np.asarray(fleet.service.rng_keys)
    out["fleet_preds"] = fleet.infer(xs[:10])

    for tag, s_vals, t_vals in (("grid", (1.375, 3.0), (5, 15)),
                                ("cells", (1.375,), (5, 15)),
                                ("one", (1.375,), (15,))):
        osets, _ = blocks.iris_paper_sets(n_orderings=4)
        res = CrossValRun(cfg, mesh=mesh).sweep(
            osets.offline_x, osets.offline_y, osets.validation_x,
            osets.validation_y, s_vals, t_vals, n_epochs=2, seed=3)
        out["sweep_" + tag] = np.asarray(res.val_accuracy)
        out["sweep_mean_" + tag] = np.asarray(res.mean_accuracy)
    g = hpsearch.grid_search(cfg, (1.375, 3.0), (5, 15), osets.offline_x,
                             osets.offline_y, osets.validation_x,
                             osets.validation_y, n_epochs=2, seed=3,
                             mesh=mesh)
    out["grid_search"] = np.asarray(g.val_accuracy)

    on, n_off = osets.offline_y.shape
    tv = np.ones((on, n_off), dtype=bool)
    tv[:, 20:] = False
    sets = mgr.Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((on, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=tv)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    st, accs, act = mgr.run_orderings(
        cfg, mgr.SystemConfig(2, 2),
        jax.vmap(lambda _: init_state(cfg))(jnp.arange(4)),
        init_runtime(cfg, s=1.375, T=15), jax.tree.map(jnp.asarray, sets),
        mgr.make_schedule(online_s=1.0), keys, mesh=mesh)
    out["orderings_ta"] = np.asarray(st.ta_state)
    out["orderings_acc"] = np.asarray(accs)
    out["orderings_act"] = np.asarray(act)

    man = TMFleetAdaptManager(
        cfg, init_state(cfg), init_runtime(cfg, s=3.0, T=15), xs[100:],
        ys[100:], n_replicas=4,
        oc=TMOnlineAdaptConfig(analyze_every=4, rollback_threshold=0.05,
                               chunk=2, buffer_capacity=8),
        seed=[3, 1, 4, 1], mesh=mesh)
    out["adapt_offline"] = man.offline_train(xs[:60], ys[:60], n_epochs=2)
    for i in range(16):
        idx = [(i * 5 + r * 11) % 100 for r in range(4)]
        man.observe_rows(xs[idx], ys[idx])
    out["adapt_ta"] = np.asarray(man.service.ss.tm.ta_state)
    out["adapt_keys"] = np.asarray(man.service.rng_keys)
    out["adapt_hist"] = np.asarray([h[1] for h in man.history])
    out["adapt_rollbacks"] = np.asarray(man.rollbacks)
    from repro.serve import ServiceConfig, TMService
    for k in (16, 6, 3):
        svc = TMService(cfg, init_state(cfg), ServiceConfig(
            replicas=k, resident="auto", s=3.0, T=15, mesh=mesh))
        svc._res.note_active(5)
        out[f"granule_{k}"] = np.asarray(
            [svc.n_resident, svc._res.autotune_target(granule=svc._granule)])
    np.savez(sys.argv[1], **out)
    print("OK")
""")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several pytest
    workers at once, and torch's intra-op threads on top of them
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's runs on four forced host devices (one subprocess
    for the module)."""
    path = tmp_path_factory.mktemp("jax_mesh") / "sharded.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT / "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


def _bits(a) -> np.ndarray:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# Mesh, device_put / gather, the replica_shardings rule
# ---------------------------------------------------------------------------


def test_mesh_reads_like_the_reference():
    m = make_host_mesh(devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model")
    assert dict(m.shape) == {"data": 4, "model": 1}
    assert m.devices.size == 4 and m.devices.shape == (4, 1)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert shard_mod.slab_devices(m) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="model"):
        make_host_mesh(model=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="axes"):
        Mesh(["cpu"] * 4, ("data", "model"))


def test_mesh_naming_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        Mesh(["cuda"] * 4, ("data",))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


@pytest.mark.parametrize("make", [
    lambda m: TMService(CFG, init_state(CFG, device="cpu"),
                        ServiceConfig(replicas=4, mesh=m), device="cpu"),
    lambda m: OnlineFleet(CFG, init_state(CFG, device="cpu"),
                          init_runtime(CFG, device="cpu"), n_replicas=4,
                          mesh=m, device="cpu"),
    lambda m: t_cv.CrossValRun(CFG, device="cpu", mesh=m),
    lambda m: shard_mod.replica_shardings({}, m, n_replicas=4),
], ids=["service", "fleet", "crossval", "replica_shardings"])
def test_non_mesh_object_is_a_type_error(make):
    with pytest.raises(TypeError, match="Mesh"):
        make(object())
    make(MESH)


def test_device_put_and_gather_round_trip():
    x = torch.arange(8 * 3).reshape(8, 3)
    sh = shard_mod.replica_shardings({"full": x, "stream": x[:4]}, MESH,
                                     n_replicas=8)
    full = shard_mod.device_put(x, sh["full"])
    assert [tuple(s.shape) for s in full.shards] == [(2, 3)] * 4
    assert full.bounds == ((0, 2), (2, 4), (4, 6), (6, 8))
    assert full.shape == (8, 3)
    assert torch.equal(shard_mod.gather(full), x)
    rep = shard_mod.device_put(x[:4], sh["stream"])
    # one copy per distinct device: the repeated CPU shares one tensor
    assert all(s is rep.shards[0] for s in rep.shards)
    assert torch.equal(shard_mod.gather(rep), x[:4])
    slabs = shard_mod.slabs({"full": full, "stream": rep})
    assert [(s.lo, s.hi) for s in slabs] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert torch.equal(slabs[2].tree["full"], x[4:6])
    assert slabs[2].tree["stream"] is rep.shards[0]


@pytest.mark.parametrize("leaf,n,sharded", [
    ("full", 16, True), ("stream", 16, False), ("scalar", 16, False),
    ("odd", 16, False), ("odd", 6, False),
], ids=["full_R_shards", "D_stream_replicates", "scalar_replicates",
        "other_leading_dim_replicates", "nondivisible_R_replicates"])
def test_replica_shardings_rule(jax_sharded, leaf, n, sharded):
    tree = {"full": torch.zeros((16, 3, 16, 32), dtype=torch.int8),
            "stream": torch.zeros((4, 30, 16), dtype=torch.bool),
            "odd": torch.zeros((6, 2), dtype=torch.int32),
            "scalar": torch.zeros(())}
    spec = shard_mod.replica_shardings(tree, MESH, n_replicas=n)[leaf].spec
    want = shard_mod.PartitionSpec("data") if sharded else (
        shard_mod.PartitionSpec())
    assert spec == want
    ref = jax_sharded["spec_odd6" if n == 6 else "spec_" + leaf]
    assert bool(ref) == sharded


def test_replica_shardings_needs_n_replicas():
    with pytest.raises(TypeError, match="n_replicas"):
        shard_mod.replica_shardings({"a": torch.zeros(8)}, MESH)


# ---------------------------------------------------------------------------
# The fleet, the sweep, the orderings, the adapt manager
# ---------------------------------------------------------------------------


def _fleet(mesh):
    xs, ys = iris.load()
    fleet = OnlineFleet(CFG, init_state(CFG, device="cpu"),
                        init_runtime(CFG, s=3.0, T=15, device="cpu"),
                        n_replicas=K, buffer_capacity=16, chunk=4,
                        seed=list(range(K)), mesh=mesh, device="cpu")
    for i in range(12):
        fleet.offer_rows(
            np.stack([xs[(i + 7 * r) % 150] for r in range(K)]),
            np.asarray([int(ys[(i + 7 * r) % 150]) for r in range(K)]))
    # unequal budgets: the four slabs loop to different counts
    t1 = fleet.drain(np.asarray([1, 2, 3, 4, 9, 12, 0, 5]))
    t2 = fleet.drain(6)
    return fleet, t1, t2, fleet.infer(xs[:10])


def test_fleet_mesh_sharded_bitwise_equal_to_unsharded(jax_sharded):
    (base, b1, b2, bp), (shd, s1, s2, sp) = _fleet(None), _fleet(MESH)
    assert len(shd.service._slabs) == 4
    assert _eq(b1, s1) and _eq(b2, s2) and _eq(bp, sp)
    for f in ("ta", "head", "size", "step", "keys", "trained", "trained2",
              "preds"):
        got = {"ta": shd.ss.tm.ta_state, "head": shd.ss.buf.head,
               "size": shd.ss.buf.size, "step": shd.ss.step,
               "keys": shd.service.rng_keys, "trained": s1,
               "trained2": s2, "preds": sp}[f]
        assert _eq(jax_sharded["fleet_" + f], got), f
    for a, b in zip((base.ss.tm.ta_state, *base.ss.buf, base.ss.step),
                    (shd.ss.tm.ta_state, *shd.ss.buf, shd.ss.step)):
        assert torch.equal(a, b)
    assert _eq(base.service.rng_keys, shd.service.rng_keys)


def test_fleet_mesh_slabs_with_unequal_budgets_keep_masked_replicas():
    """A slab loops to its own largest count: the replicas of a slab whose
    budget is spent (or zero) keep their banks, rings, step counters and
    keys through the other slabs' longer chunks, and the monitored chunk
    aux is the unsharded one."""
    xs, ys = iris.load()
    runs = []
    for mesh in (None, MESH):
        fleet = OnlineFleet(CFG, init_state(CFG, device="cpu"),
                            init_runtime(CFG, s=3.0, T=15, device="cpu"),
                            n_replicas=K, buffer_capacity=16, chunk=4,
                            seed=5, mesh=mesh, device="cpu")
        for i in range(10):
            fleet.offer_rows(xs[i * 7:i * 7 + K], ys[i * 7:i * 7 + K])
        before = fleet.service.rng_keys.copy()
        auxes = []
        budget = np.asarray([0, 0, 7, 1, 3, 3, 10, 2])
        trained = fleet.drain(budget, on_chunk=auxes.append)
        after = fleet.service.rng_keys
        assert _eq(before[:2], after[:2])          # slab 0 sat it out
        runs.append((trained, fleet.ss, after, auxes))
    (t0, ss0, k0, a0), (t1, ss1, k1, a1) = runs
    assert _eq(t0, t1) and _eq(k0, k1) and len(a0) == len(a1) == 3
    for a, b in zip((ss0.tm.ta_state, *ss0.buf, ss0.step),
                    (ss1.tm.ta_state, *ss1.buf, ss1.step)):
        assert torch.equal(a, b)
    for x, y in zip(a0, a1):
        assert all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.parametrize("tag,s_vals,t_vals,slab", [
    ("grid", (1.375, 3.0), (5, 15), 4), ("cells", (1.375,), (5, 15), 2),
    ("one", (1.375,), (15,), 1)],
    ids=["streams_as_they_are", "gathered_streams", "one_cell"])
def test_crossval_mesh_sharded_sweep_bitwise_equal(jax_sharded, tag,
                                                   s_vals, t_vals, slab):
    """The sweep in four slabs, bitwise the unsharded sweep and the JAX
    package's sharded one: slabs of 4 orderings, slabs of 2 (the gathered
    streams), and a single cell (R = O, slabs of 1)."""
    osets, _ = blocks.iris_paper_sets(n_orderings=4)
    args = (osets.offline_x, osets.offline_y, osets.validation_x,
            osets.validation_y, s_vals, t_vals)
    base = t_cv.CrossValRun(CFG, device="cpu").sweep(*args, n_epochs=2,
                                                     seed=3)
    eng = t_cv.CrossValRun(CFG, mesh=MESH)
    assert eng.dev == torch.device("cpu")
    put = eng._put(torch.zeros(base.replicas), n_replicas=base.replicas)
    assert [s.hi - s.lo for s in put] == [slab] * 4
    shd = eng.sweep(*args, n_epochs=2, seed=3)
    assert _eq(base.val_accuracy, shd.val_accuracy)
    assert _eq(base.mean_accuracy, shd.mean_accuracy)
    assert _eq(jax_sharded["sweep_" + tag], shd.val_accuracy)
    assert _eq(jax_sharded["sweep_mean_" + tag], shd.mean_accuracy)


def test_grid_search_with_mesh(jax_sharded):
    osets, _ = blocks.iris_paper_sets(n_orderings=4)
    g = hpsearch.grid_search(CFG, (1.375, 3.0), (5, 15), osets.offline_x,
                             osets.offline_y, osets.validation_x,
                             osets.validation_y, n_epochs=2, seed=3,
                             mesh=MESH)
    assert _eq(jax_sharded["grid_search"], g.val_accuracy)


def test_slab_streams_gather_one_row_per_replica():
    streams = (torch.arange(4 * 3).reshape(4, 3), torch.arange(4))
    same = t_cv._slab_streams(streams, 8, 12, 4)
    assert same is streams
    got = t_cv._slab_streams(streams, 2, 4, 4)
    assert got[1].tolist() == [2, 3]
    got = t_cv._slab_streams(streams, 6, 9, 4)
    assert got[1].tolist() == [2, 3, 0]


def test_run_orderings_with_mesh(jax_sharded):
    osets, _ = blocks.iris_paper_sets(n_orderings=4)
    on, n_off = osets.offline_y.shape
    tv = np.ones((on, n_off), dtype=bool)
    tv[:, 20:] = False
    sets = t_mgr.Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((on, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=tv)
    from repro_torch import random as rnd
    keys = rnd.split(rnd.PRNGKey(9, "cpu"), 4)
    outs = [t_mgr.run_orderings(
        CFG, t_mgr.SystemConfig(2, 2), t_cv.replicate_state(CFG, 4, "cpu"),
        init_runtime(CFG, s=1.375, T=15, device="cpu"),
        convert.sets_from_numpy(sets, "cpu"),
        t_mgr.make_schedule(online_s=1.0), keys, mesh=m)
        for m in (None, MESH)]
    for a, b in zip(*outs):
        assert torch.equal(a.ta_state if hasattr(a, "ta_state") else a,
                           b.ta_state if hasattr(b, "ta_state") else b)
    st, accs, act = outs[1]
    assert _eq(jax_sharded["orderings_ta"], st.ta_state)
    assert _eq(jax_sharded["orderings_acc"], accs)
    np.testing.assert_allclose(act.numpy(), jax_sharded["orderings_act"],
                               rtol=ACT_RTOL, atol=0)


def test_fleet_adapt_manager_with_mesh(jax_sharded):
    xs, ys = iris.load()
    runs = []
    for mesh in (None, MESH):
        man = TMFleetAdaptManager(
            CFG, init_state(CFG, device="cpu"),
            init_runtime(CFG, s=3.0, T=15, device="cpu"), xs[100:],
            ys[100:], n_replicas=4,
            oc=TMOnlineAdaptConfig(analyze_every=4, rollback_threshold=0.05,
                                   chunk=2, buffer_capacity=8),
            seed=[3, 1, 4, 1], mesh=mesh, device="cpu")
        off = man.offline_train(xs[:60], ys[:60], n_epochs=2)
        for i in range(16):
            idx = [(i * 5 + r * 11) % 100 for r in range(4)]
            man.observe_rows(xs[idx], ys[idx])
        runs.append((off, man))
    (o0, m0), (o1, m1) = runs
    assert len(m1.service._slabs) == 4
    assert isinstance(m1.service._ps.best_state, list)
    for off, man in runs:
        assert _eq(jax_sharded["adapt_offline"], off)
        assert _eq(jax_sharded["adapt_ta"], man.service.ss.tm.ta_state)
        assert _eq(jax_sharded["adapt_keys"], man.service.rng_keys)
        assert _eq(jax_sharded["adapt_hist"],
                   np.asarray([h[1] for h in man.history]))
        assert _eq(jax_sharded["adapt_rollbacks"], man.rollbacks)


@pytest.mark.parametrize("replicas,want", [(16, 4), (6, 4), (3, 3)])
def test_auto_residency_granule_rounds_to_the_mesh(jax_sharded, replicas,
                                                   want):
    """``resident="auto"`` starts at a quarter of the fleet rounded up to
    the mesh's device count (capped at the fleet), as the reference; the
    autotuned targets round the same way."""
    svc = TMService(CFG, init_state(CFG, device="cpu"), ServiceConfig(
        replicas=replicas, resident="auto", s=3.0, T=15, mesh=MESH),
        device="cpu")
    assert svc.n_resident == want
    assert len(svc._slabs) == (4 if want % 4 == 0 else 1)
    svc._res.note_active(5)
    target = svc._res.autotune_target(granule=svc._granule)
    assert target == min(replicas, 8)      # ceil(5 * 1.5) = 8, granule 4
    assert _eq(jax_sharded[f"granule_{replicas}"], [want, target])
