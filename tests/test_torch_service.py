"""The port's K = 1 TMService against the reference's, bit for bit.

The quickstart's flow (examples/quickstart.py: offline_train -> submit +
tick -> serve) on iris, and the same flow with monitoring, backpressure
and rollbacks on the MNIST-scale machine at 7 x 7, run on both packages
from the same seeds and rows. TA banks, keys, tick reports, histories,
drops, chunk monitoring and served predictions must agree exactly.

The mesh cases shard a K = 8 packed, tunable service over four CPU slabs
(``Mesh(["cpu"] * 4, ("data",))``): its run, its tunable serves and its
checkpoints are held bitwise against the port without a mesh and against
the JAX package's sharded service on four forced host devices (one
subprocess for the module, which also writes a checkpoint the port
restores with and without a mesh).
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import tm_mnist as j_mnist_cfg
from repro.configs.tm_iris import CONFIG as J_IRIS
from repro.core import init_state as j_init_state
from repro.core.online import OnlineSession as JSession
from repro.core import init_runtime as j_init_runtime
from repro.data import iris
from repro.data import mnist
from repro.serve import AdaptPolicy as JPolicy
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import TunableConfig as JTunable
from repro_torch.configs import tm_mnist as t_mnist_cfg
from repro_torch.configs.tm_iris import CONFIG as T_IRIS
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import init_state as t_init_state
from repro_torch.core.online import OnlineSession as TSession
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import AdaptPolicy as TPolicy
from repro_torch.serve import ServiceConfig as TConfig
from repro_torch.serve import TMService as TService
from repro_torch.serve import TunableConfig as TTunable
import dataclasses

BACKENDS = ["cuda", "ref"]
MESH = Mesh(["cpu"] * 4, ("data",))     # four slabs of the replica axis


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread. The suite runs several pytest workers
    at once; torch's intra-op threads on top of them oversubscribe the
    cores, and an MNIST-width flow then ran 20-40x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b) -> bool:
    return np.array_equal(_np(a), _np(b))


def _quickstart(Service, Config, Policy, init_state, cfg, **dev):
    xs, ys = iris.load()
    svc = Service(cfg, init_state(cfg, **dev),
                  Config(replicas=1, buffer_capacity=32, chunk=8, s=1.0, T=15,
                         policy=Policy(analyze_every=16)),
                  eval_x=xs[100:], eval_y=ys[100:], **dev)
    base = svc.offline_train(xs[:20], ys[:20], n_epochs=10)
    reports = []
    for i in range(32):
        svc.submit(0, xs[20 + i], int(ys[20 + i]))
        reports.append(svc.tick())
    return dict(svc=svc, base=base, reports=reports,
                served=svc.serve(xs[:50]))


def _mnist_flow(Service, Config, Policy, init_state, cfg, **dev):
    xs, ys = mnist.load(n_points=150, side=7)
    svc = Service(cfg, init_state(cfg, **dev),
                  Config(replicas=1, buffer_capacity=16, chunk=6,
                         ingress_block=4, s=1.5, T=32,
                         policy=Policy(analyze_every=8,
                                       rollback_threshold=0.02)),
                  eval_x=xs[100:], eval_y=ys[100:], **dev)
    base = svc.offline_train(xs[:30], ys[:30], n_epochs=2)
    chunks, reports, accepted = [], [], []
    for i in range(30, 100):
        accepted.append(svc.submit(0, xs[i], int(ys[i])))
        if i % 10 == 0:             # 10 rows in, <= 7 out: backpressure
            reports.append(svc.tick(max_points=3 + i % 7,
                                    on_chunk=chunks.append))
    reports.append(svc.tick(max_points=64, on_chunk=chunks.append))
    return dict(svc=svc, base=base, reports=reports, chunks=chunks,
                accepted=accepted, served=svc.serve(xs[100:]))


def _compare(j, t):
    js, ts = j["svc"], t["svc"]
    assert _eq(j["base"], t["base"])
    assert _eq(js.ss.tm.ta_state, ts.ss.tm.ta_state.numpy())
    for f in ("data_x", "data_y", "head", "size"):
        assert _eq(getattr(js.ss.buf, f), getattr(ts.ss.buf, f).numpy()), f
    assert _eq(js.rng_keys, ts.rng_keys)
    assert _eq(js.steps, ts.steps)
    assert _eq(js.dropped, ts.dropped)
    assert _eq(js.buffered, ts.buffered)
    assert _eq(js.rollbacks, ts.rollbacks)
    assert len(j["reports"]) == len(t["reports"])
    for rj, rt in zip(j["reports"], t["reports"]):
        assert _eq(rj.trained, rt.trained)
        assert _eq(rj.rolled_back, rt.rolled_back)
        assert (rj.accuracy is None) == (rt.accuracy is None)
        if rj.accuracy is not None:
            assert _eq(rj.accuracy, rt.accuracy)
    assert len(js.history) == len(ts.history)
    for (sj, aj), (st, at) in zip(js.history, ts.history):
        assert _eq(sj, st) and _eq(aj, at)
    assert _eq(j["served"], t["served"])


@pytest.fixture(scope="module")
def jax_quickstart():
    return _quickstart(JService, JConfig, JPolicy, j_init_state, J_IRIS.tm)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_flow_matches_reference(jax_quickstart, backend):
    cfg = dataclasses.replace(T_IRIS.tm, backend=backend)
    t = _quickstart(TService, TConfig, TPolicy, t_init_state, cfg,
                    device="cpu")
    _compare(jax_quickstart, t)
    assert any(r.accuracy is not None for r in t["reports"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_mnist_side7_flow_matches_reference(backend):
    j = _mnist_flow(JService, JConfig, JPolicy, j_init_state,
                    j_mnist_cfg.config_for_side(7).tm)
    cfg = dataclasses.replace(t_mnist_cfg.config_for_side(7).tm,
                              backend=backend)
    t = _mnist_flow(TService, TConfig, TPolicy, t_init_state, cfg,
                    device="cpu")
    _compare(j, t)
    assert j["accepted"] == t["accepted"]
    assert int(t["svc"].dropped[0]) > 0
    assert len(j["chunks"]) == len(t["chunks"]) > 0
    for cj, ct in zip(j["chunks"], t["chunks"]):
        for f in cj._fields:
            assert _eq(getattr(cj, f), getattr(ct, f).numpy()), f


def test_online_session_shim_matches_reference():
    """The shim, with budgets past the buffered rows: the chunk monitor's
    unconsumed columns must match the reference's masked scan steps."""
    xs, ys = iris.load()
    jc = J_IRIS.tm
    tc = dataclasses.replace(T_IRIS.tm, backend="cuda")
    js = JSession(jc, j_init_state(jc), j_init_runtime(jc, s=1.375),
                  buffer_capacity=12, chunk=5, seed=3)
    ts = TSession(tc, t_init_state(tc, device="cpu"),
                  t_init_runtime(tc, s=1.375, device="cpu"),
                  buffer_capacity=12, chunk=5, seed=3, device="cpu")
    aj, at = [], []
    for start in (0, 15, 40):
        for i in range(start, start + 14):
            assert js.offer(xs[i], int(ys[i])) == ts.offer(xs[i], int(ys[i]))
        assert js.learn_available(9, on_chunk=aj.append) == \
            ts.learn_available(9, on_chunk=at.append)
        assert js.learn_available(20, on_chunk=aj.append) == \
            ts.learn_available(20, on_chunk=at.append)
    assert js.dropped == ts.dropped and js.buffered == ts.buffered
    assert _eq(js.ss.tm.ta_state, ts.ss.tm.ta_state.numpy())
    assert _eq(js.ss.step, ts.ss.step.numpy())
    assert len(aj) == len(at)
    for a, b in zip(aj, at):
        for f in a._fields:
            assert _eq(getattr(a, f), getattr(b, f).numpy()), f
    assert _eq(js.infer(xs), ts.infer(xs))


@pytest.mark.parametrize("sc", [
    dict(resident=1), dict(resident="auto"), dict(replicas=4, resident=2),
    dict(replicas=4, resident=2, tunable=TTunable(budget=0.5)),
    dict(mesh=object()),
])
def test_later_slices_raise(sc):
    """Fleets, packing, per-replica ports, tunable serving, residency and
    the mesh are all served now; a mesh that is not the port's ``Mesh``
    is a ``TypeError``. Each case constructs and drives the service beside
    the JAX one (iris rows into a random subset of replicas, ticks with
    analysis every 8 points, then ``serve_replicas``, calibrated and
    budgeted in the tunable case) and must agree bit for bit; the mesh
    case runs a real four-slab mesh beside the JAX service without one."""
    cfg = T_IRIS.tm
    if "mesh" in sc:
        with pytest.raises(TypeError, match="Mesh"):
            TService(cfg, t_init_state(cfg, device="cpu"), TConfig(**sc),
                     device="cpu")
        sc = dict(replicas=4, mesh=MESH)
    xs, ys = iris.load()
    jsc = {k: v for k, v in sc.items() if k != "mesh"}
    if "tunable" in sc:
        jsc["tunable"] = JTunable(**dataclasses.asdict(sc["tunable"]))
    knobs = dict(s=3.0, T=15, chunk=4, buffer_capacity=16, ingress_block=4)
    ev = dict(eval_x=xs[100:], eval_y=ys[100:])
    js = JService(J_IRIS.tm, j_init_state(J_IRIS.tm), JConfig(
        policy=JPolicy(analyze_every=8), **knobs, **jsc), **ev)
    ts = TService(cfg, t_init_state(cfg, device="cpu"), TConfig(
        policy=TPolicy(analyze_every=8), **knobs, **sc), device="cpu", **ev)
    K = ts.n_replicas
    rng = np.random.default_rng(0)
    for i in range(24):
        idx = rng.integers(0, 100, K)
        mask = rng.random(K) < 0.6
        assert _eq(js.submit_rows(xs[idx], ys[idx], mask),
                   ts.submit_rows(xs[idx], ys[idx], mask))
        if i % 3 == 2:
            rj, rt = js.tick(), ts.tick()
            assert _eq(rj.trained, rt.trained)
            assert _eq(rj.rolled_back, rt.rolled_back)
            assert (rj.accuracy is None) == (rt.accuracy is None)
            if rj.accuracy is not None:
                assert np.array_equal(rj.accuracy, rt.accuracy,
                                      equal_nan=True)
    assert ts.n_resident == js.n_resident
    assert _eq(ts.resident, js.resident)
    assert _eq(js.ss.tm.ta_state, ts.ss.tm.ta_state.numpy())
    assert _eq(js.rng_keys, ts.rng_keys) and _eq(js.steps, ts.steps)
    assert _eq(js.buffered, ts.buffered) and _eq(js.rollbacks, ts.rollbacks)
    assert len(js.history) == len(ts.history) > 0
    rids = np.arange(K)[::-1]
    if "tunable" in sc:
        assert _eq(js.calibrate(), ts.calibrate())
        pj, aj = js.serve_replicas(rids, xs[:50], budget=0.5,
                                   return_aux=True)
        pt, at = ts.serve_replicas(rids, xs[:50], budget=0.5,
                                   return_aux=True)
        assert _eq(pj, pt) and _eq(aj.evaluated, at.evaluated)
    assert _eq(js.serve_replicas(rids, xs[:50]),
               ts.serve_replicas(rids, xs[:50]))
    assert _eq(js.ss.tm.ta_state, ts.ss.tm.ta_state.numpy())


def test_durable_state_raises(tmp_path):
    """save/load/restore serve every residency budget: a checkpoint of a
    wholly resident fleet restores at resident 1 and "auto" holding the
    same logical fleet, as the JAX package's restore of it does; loading
    a missing checkpoint still raises."""
    cfg = T_IRIS.tm
    xs, ys = iris.load()
    svc = TService(cfg, t_init_state(cfg, device="cpu"),
                   TConfig(replicas=2, s=3.0, T=15, chunk=4), device="cpu")
    for i in range(10):
        svc.submit_rows(xs[[i, 50 + i]], ys[[i, 50 + i]])
    svc.tick()
    svc.save(str(tmp_path))
    svc.load(str(tmp_path))
    for resident in (1, "auto"):
        ts = TService.restore(str(tmp_path), resident=resident, device="cpu")
        js = JService.restore(str(tmp_path), resident=resident)
        assert ts.n_resident == js.n_resident == 1
        assert ts.sc.resident == resident
        for other in (svc, js):
            o = other.ss
            assert _eq(o.tm.ta_state, ts.ss.tm.ta_state.numpy())
            for f in ("data_x", "data_y", "head", "size"):
                assert _eq(getattr(o.buf, f), getattr(ts.ss.buf, f).numpy())
            assert _eq(other.rng_keys, ts.rng_keys)
            assert _eq(other.steps, ts.steps)
            assert _eq(other.buffered, ts.buffered)
    with pytest.raises(FileNotFoundError):
        svc.load(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# The replica-axis mesh: a packed, tunable K = 8 service on four CPU slabs
# against the JAX package's sharded service on four forced host devices
# ---------------------------------------------------------------------------

MESH_KNOBS = dict(replicas=8, buffer_capacity=16, chunk=4, ingress_block=4,
                  s=3.0, T=15, seed=11, packed=True)

JAX_MESH_SCRIPT = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import jax
    import numpy as np
    from jax.sharding import Mesh
    assert len(jax.devices()) == 4, jax.devices()
    import test_torch_service as ts

    svc = ts._mesh_service("jax", Mesh(np.array(jax.devices()), ("data",)))
    ts._mesh_drive(svc, 0)
    svc.calibrate()
    svc.save(sys.argv[2])
    out = {"mid_" + k: v for k, v in ts._mesh_results(svc).items()}
    ts._mesh_drive(svc, 1)
    out.update({"end_" + k: v for k, v in ts._mesh_results(svc).items()})
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def _mesh_service(pkg, mesh):
    """The K = 8 packed tunable service of the mesh cases, in the JAX
    package (``pkg="jax"``) or the port."""
    xs, ys = iris.load()
    ev = dict(eval_x=xs[100:], eval_y=ys[100:])
    tun = dict(budget=0.5, weight_bits=2, early_exit=True, group=4)
    if pkg == "jax":
        return JService(J_IRIS.tm, j_init_state(J_IRIS.tm), JConfig(
            policy=JPolicy(analyze_every=8), tunable=JTunable(**tun),
            mesh=mesh, **MESH_KNOBS), **ev)
    return TService(T_IRIS.tm, t_init_state(T_IRIS.tm, device="cpu"),
                    TConfig(policy=TPolicy(analyze_every=8),
                            tunable=TTunable(**tun), mesh=mesh,
                            **MESH_KNOBS), device="cpu", **ev)


def _mesh_drive(svc, seed, n=24):
    """Rows into a random subset of the replicas, a tick every third."""
    xs, ys = iris.load()
    rng = np.random.default_rng(seed)
    for i in range(n):
        idx = rng.integers(0, 100, 8)
        svc.submit_rows(xs[idx], ys[idx], rng.random(8) < 0.7)
        if i % 3 == 2:
            svc.tick()


def _arr(x) -> np.ndarray:
    x = x.cpu().numpy() if torch.is_tensor(x) else np.array(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _mesh_results(svc) -> dict:
    """The logical fleet, the policy, the history and the tunable serves
    (calibrated ranks; budgeted with weights and early exit; the live
    budget) as numpy arrays."""
    xs, _ = iris.load()
    ss = svc.ss
    out = {name: _arr(leaf) for name, leaf in zip(
        ("ta", "data_x", "data_y", "head", "size", "step"),
        (ss.tm.ta_state, *ss.buf, ss.step))}
    for name in ("rng_keys", "steps", "buffered", "rollbacks",
                 "since_analysis"):
        out[name] = _arr(getattr(svc, name))
    out["best"] = _arr(svc._ps.best)
    out["hist_acc"] = _arr(np.stack([np.asarray(h[1])
                                     for h in svc.history]))
    out["scores"] = _arr(svc.calibrate())
    preds, aux = svc.serve(xs[:30], budget=0.25, return_aux=True)
    out["pruned"], out["evaluated"], out["sel"] = (
        _arr(preds), _arr(aux.evaluated), _arr(aux.sel))
    out["live"] = _arr(svc.serve(xs[:30]))
    rids = np.arange(8)[::-1]
    out["replicas"] = _arr(svc.serve_replicas(rids, xs[:30], budget=0.5))
    return out


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded service on four forced host devices (one
    subprocess for the module): its results and the checkpoint it wrote
    between its two halves."""
    tests = pathlib.Path(__file__).resolve().parent
    tmp = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tests.parent / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", JAX_MESH_SCRIPT, str(tmp / "out.npz"),
         str(tmp / "ckpt"), str(tests)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(tmp / "out.npz")), str(tmp / "ckpt")


def _same(want: dict, prefix: str, got: dict):
    want = {k[len(prefix):]: v for k, v in want.items()
            if k.startswith(prefix)}
    assert set(want) == set(got)
    for name, v in want.items():
        assert np.array_equal(v, got[name]), name


def test_service_mesh_tunable_matches_jax_sharded(jax_sharded):
    """The sharded service's run and tunable serves (K7 replicated on every
    slab) are bitwise the unsharded port's and the JAX sharded run's."""
    want, _ = jax_sharded
    for mesh in (None, MESH):
        svc = _mesh_service("torch", mesh)
        assert len(svc._slabs) == (1 if mesh is None else 4)
        _mesh_drive(svc, 0)
        svc.calibrate()
        _same(want, "mid_", _mesh_results(svc))
        _mesh_drive(svc, 1)
        _same(want, "end_", _mesh_results(svc))


@pytest.mark.parametrize("writer,reader", [
    ("jax_mesh", MESH), ("jax_mesh", None), ("port_mesh", None),
    ("port_plain", MESH)],
    ids=["jax_sharded_to_mesh", "jax_sharded_to_plain",
         "mesh_to_plain", "plain_to_mesh"])
def test_service_mesh_checkpoints_restore_across(jax_sharded, tmp_path,
                                                 writer, reader):
    """A checkpoint is the full-K layout with or without a mesh: one the
    JAX sharded service wrote, or the port wrote with or without a mesh,
    restores with or without one and continues bitwise as the JAX sharded
    service continued."""
    want, jax_ckpt = jax_sharded
    if writer == "jax_mesh":
        ckpt = jax_ckpt
    else:
        svc = _mesh_service("torch", MESH if writer == "port_mesh" else None)
        _mesh_drive(svc, 0)
        svc.calibrate()
        ckpt = str(tmp_path)
        svc.save(ckpt)
    xs, ys = iris.load()
    back = TService.restore(ckpt, mesh=reader, eval_x=xs[100:],
                            eval_y=ys[100:],
                            device=None if reader is not None else "cpu")
    assert back.mesh is reader
    assert len(back._slabs) == (1 if reader is None else 4)
    _same(want, "mid_", _mesh_results(back))
    _mesh_drive(back, 1)
    _same(want, "end_", _mesh_results(back))
