"""The port's fleet (TMService at K > 1, OnlineFleet, the adapt managers)
and its packed service against the JAX package, bit for bit.

Both packages run the same flows from the same seeds and rows, made with
numpy: the fleet drain at K in {1, 3, 8} (banks, rings, keys, steps and
every chunk's ``ChunkAux``), uneven streams and budgets, per-replica s/T
ports, backpressure and ``dropped`` counts, the vectorised ring enqueue
when rings fill, the fleet adapt manager's per-replica rollback and
cadence, and the packed service at f in {16, 33, 49} (against the
reference's packed service and the port's unpacked one). The JAX side
runs backend "ref", and "pallas" (interpret mode) where its Pallas kernels
are reached; the port runs "cuda" (on CPU tensors: the kernels' plain
versions) and "ref".

The mesh cases shard the replica axis over four CPU slabs
(``Mesh(["cpu"] * 4, ("data",))``) and hold the port bitwise against its
unsharded run and against the JAX package's sharded run on four forced
host devices (one subprocess for the module, results through an
``.npz``): the per-replica-ports tick flow, packed and unpacked.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_runtime as j_init_runtime
from repro.core import init_state as j_init_state
from repro.data import iris
from repro.data import mnist
from repro.kernels import packing as j_packing
from repro.serve import AdaptPolicy as JPolicy
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import router as j_router
from repro.serve.fleet import OnlineFleet as JFleet
from repro.serve.online_adapt import TMFleetAdaptManager as JFleetManager
from repro.serve.online_adapt import TMOnlineAdaptConfig as JAdaptConfig
from repro_torch import convert
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import init_state as t_init_state
from repro_torch.core.online import OnlineSession as TSession
from repro_torch.core.tm import TMState as TTMState
from repro_torch.data import buffer as t_buf
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import AdaptPolicy as TPolicy
from repro_torch.serve import ServiceConfig as TConfig
from repro_torch.serve import TMFleetAdaptManager as TFleetManager
from repro_torch.serve import TMOnlineAdaptConfig as TAdaptConfig
from repro_torch.serve import TMService as TService
from repro_torch.serve import router as t_router
from repro_torch.serve.fleet import OnlineFleet as TFleet

IRIS = dict(n_features=16, max_classes=3, max_clauses=16, n_states=16)
MESH = Mesh(["cpu"] * 4, ("data",))     # four slabs of the replica axis


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several pytest
    workers at once, and torch's intra-op threads on top of them
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX = dict(Service=JService, Config=JConfig, Policy=JPolicy,
           Fleet=JFleet, init_state=j_init_state, dev={})
TORCH = dict(Service=TService, Config=TConfig, Policy=TPolicy,
             Fleet=TFleet, init_state=t_init_state, dev=dict(device="cpu"))


def _cfgs(jax_backend="ref", port_backend="cuda", **kw):
    base = dict(IRIS, **kw)
    return (JTMConfig(backend=jax_backend, **base),
            TTMConfig(backend=port_backend, **base))


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(a, b) -> bool:
    return np.array_equal(_np(a), _np(b))


def _same_state(jss, tss):
    """Banks, rings (rows, labels, head, size) and step counters."""
    want = jax.tree.leaves(jax.tree.map(np.asarray, jss))
    got = jax.tree.leaves(convert.session_state_to_numpy(tss))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and _eq(w, g)


def _same_chunks(jc, tc):
    assert len(jc) == len(tc)
    for a, b in zip(jc, tc):
        for f in a._fields:
            assert _eq(getattr(a, f), getattr(b, f).numpy()), f


def _streams(K, n, stride=7):
    """Distinct per-replica streams over the iris rows: xs [K, n, 16]."""
    xs, ys = iris.load()
    idx = (np.arange(n)[None, :] + stride * np.arange(K)[:, None]) % len(xs)
    return xs[idx], ys[idx].astype(np.int32)


def _drain_flow(pkg, cfg, K, seeds, chunk=8, packed=False, **sc):
    svc = pkg["Service"](cfg, pkg["init_state"](cfg, **pkg["dev"]),
                         pkg["Config"](replicas=K, buffer_capacity=32,
                                       chunk=chunk, seed=seeds, s=3.0, T=15,
                                       packed=packed, **sc),
                         **pkg["dev"])
    xs, ys = _streams(K, 20)
    chunks = []
    for i in range(20):
        assert svc.submit_rows(xs[:, i], ys[:, i]).all()
    trained = svc.drain(20, on_chunk=chunks.append)
    served = svc.serve(iris.load()[0][:12])
    return svc, trained, chunks, served


@pytest.mark.parametrize("K,jax_backend,port_backend", [
    (1, "ref", "cuda"), (3, "ref", "cuda"), (8, "ref", "cuda"),
    (3, "pallas", "ref"),
])
def test_fleet_drain_matches_reference(K, jax_backend, port_backend):
    jc, tc = _cfgs(jax_backend, port_backend)
    seeds = [100 + r for r in range(K)]
    js, jt, jch, jserved = _drain_flow(JAX, jc, K, seeds)
    ts, tt, tch, tserved = _drain_flow(TORCH, tc, K, seeds)
    assert _eq(jt, tt) and list(tt) == [20] * K
    _same_state(js.ss, ts.ss)
    assert _eq(js.rng_keys, ts.rng_keys)
    assert _eq(js.steps, ts.steps)
    _same_chunks(jch, tch)
    assert _eq(jserved, tserved)


def test_fleet_is_k_sessions():
    """The stacking rule in the port alone: OnlineFleet(K) with seeds
    seed[r] equals K K = 1 sessions seeded seed[r], bit for bit."""
    _, tc = _cfgs()
    K, seeds = 3, [11, 12, 13]
    rt = t_init_runtime(tc, s=3.0, T=15, device="cpu")
    xs, ys = _streams(K, 14)
    fleet = TFleet(tc, t_init_state(tc, device="cpu"), rt, n_replicas=K,
                   buffer_capacity=16, chunk=4, seed=seeds, device="cpu")
    sessions = [TSession(tc, t_init_state(tc, device="cpu"), rt,
                         buffer_capacity=16, chunk=4, seed=s, device="cpu")
                for s in seeds]
    for i in range(14):
        assert fleet.offer_rows(xs[:, i], ys[:, i]).all()
        for r, s in enumerate(sessions):
            assert s.offer(xs[r, i], int(ys[r, i]))
    assert list(fleet.drain(10)) == [s.learn_available(10) for s in sessions]
    for r, s in enumerate(sessions):
        assert torch.equal(fleet.ss.tm.ta_state[r], s.ss.tm.ta_state)
        assert torch.equal(fleet.ss.buf.head[r], s.ss.buf.head)
    q = iris.load()[0][:9]
    preds = fleet.infer(q)
    for r, s in enumerate(sessions):
        assert _eq(preds[r], s.infer(q))


def test_fleet_uneven_streams_and_budgets_match_reference():
    """Replicas that run out of rows or budget early retire as lone
    sessions do (no key split), over two drain rounds."""
    jc, tc = _cfgs()
    K, seeds = 3, [7, 8, 9]
    counts, budgets = [5, 16, 11], [3, 30, 11]
    xs, ys = _streams(K, 16)
    fleets = []
    for pkg, cfg, mk_rt in ((JAX, jc, j_init_runtime),
                            (TORCH, tc, t_init_runtime)):
        fleet = pkg["Fleet"](cfg, pkg["init_state"](cfg, **pkg["dev"]),
                             mk_rt(cfg, s=3.0, T=15, **pkg["dev"]),
                             n_replicas=K, buffer_capacity=32, chunk=4,
                             seed=seeds, **pkg["dev"])
        for r in range(K):
            for i in range(counts[r]):
                assert fleet.offer(r, xs[r, i], int(ys[r, i]))
        first = fleet.drain(np.asarray(budgets))
        for r in range(K):
            for i in range(4):
                fleet.offer(r, xs[r, i], int(ys[r, i]))
        fleets.append((fleet, first, fleet.drain(10)))
    (jf, j1, j2), (tf, t1, t2) = fleets
    assert list(t1) == list(j1) == [3, 16, 11]
    assert _eq(j2, t2)
    _same_state(jf.ss, tf.ss)
    assert _eq(jf.service.rng_keys, tf.service.rng_keys)
    assert _eq(jf.buffered, tf.buffered)


def _tick_flow(pkg, cfg, K, s, T, seeds, packed=False, n_rows=40, rows=None,
               eval_rows=None, mesh=None):
    """Offline train, masked submits with per-replica budgets and ticks,
    a final drain, then fleet and per-member serves."""
    xs, ys = rows if rows is not None else iris.load()
    ex, ey = eval_rows if eval_rows is not None else (xs[100:], ys[100:])
    svc = pkg["Service"](cfg, pkg["init_state"](cfg, **pkg["dev"]),
                         pkg["Config"](replicas=K, buffer_capacity=16,
                                       chunk=4, ingress_block=4, s=s, T=T,
                                       packed=packed, seed=seeds, mesh=mesh,
                                       policy=pkg["Policy"](analyze_every=8)),
                         eval_x=ex, eval_y=ey, **pkg["dev"])
    base = svc.offline_train(xs[:30], ys[:30], n_epochs=2)
    reports, chunks, accepted = [], [], []
    budgets = (np.arange(K) * 5) % 17 + 1   # replica 0 falls behind
    for i in range(n_rows):
        mask = (np.arange(K) + i) % 3 != 0
        accepted.append(svc.submit_rows(xs[30 + i], int(ys[30 + i]), mask))
        if i % 6 == 5:
            reports.append(svc.tick(max_points=budgets,
                                    on_chunk=chunks.append))
    reports.append(svc.tick(max_points=64, on_chunk=chunks.append))
    q = xs[:K * 7].reshape(K, 7, -1)
    return dict(svc=svc, base=base, reports=reports, chunks=chunks,
                accepted=accepted, served=svc.serve(xs[:20]),
                served_k=svc.serve(q), acc=svc.analyze())


def _compare_flows(j, t):
    js, ts = j["svc"], t["svc"]
    assert _eq(j["base"], t["base"])
    assert all(_eq(a, b) for a, b in zip(j["accepted"], t["accepted"]))
    _same_state(js.ss, ts.ss)
    for name in ("rng_keys", "steps", "dropped", "buffered", "rollbacks",
                 "lost", "since_analysis"):
        assert _eq(getattr(js, name), getattr(ts, name)), name
    assert len(j["reports"]) == len(t["reports"])
    for rj, rt in zip(j["reports"], t["reports"]):
        assert _eq(rj.trained, rt.trained) and _eq(rj.rolled_back,
                                                   rt.rolled_back)
        assert (rj.accuracy is None) == (rt.accuracy is None)
        if rj.accuracy is not None:
            assert _eq(rj.accuracy, rt.accuracy)
    assert len(js.history) == len(ts.history)
    for (sj, aj), (st, at) in zip(js.history, ts.history):
        assert _eq(sj, st) and _eq(aj, at)
    _same_chunks(j["chunks"], t["chunks"])
    for name in ("served", "served_k", "acc"):
        assert _eq(j[name], t[name]), name


@pytest.mark.parametrize("K,s,T", [
    (3, [1.375, 3.0, 5.0], [5, 15, 10]),       # per-replica ports
    (1, [2.0], [12]),                           # K = 1, replicated body
    (4, 3.0, 15),                               # scalar ports, K > 1
])
def test_service_per_replica_ports_match_reference(K, s, T):
    jc, tc = _cfgs()
    seeds = [41 + r for r in range(K)]
    j = _tick_flow(JAX, jc, K, s, T, seeds)
    t = _tick_flow(TORCH, tc, K, s, T, seeds)
    _compare_flows(j, t)
    assert any(r.accuracy is not None for r in t["reports"])
    assert int(t["svc"].dropped.sum()) > 0      # backpressure was reached


def _packed_rows(f, n, seed):
    """Rows for the packed flows: iris at f = 16, MNIST 7 x 7 at f = 49,
    random bits with a learnable label otherwise."""
    if f == 16:
        return iris.load()
    if f == 49:
        return mnist.load(n_points=n, side=7)
    rng = np.random.default_rng(seed)
    xs = rng.random((n, f)) < 0.5
    ys = (xs[:, 0].astype(np.int32) + xs[:, 1] + xs[:, 2] * 2) % 3
    return xs, ys.astype(np.int32)


@pytest.mark.parametrize("f,K,jax_backend", [
    (16, 3, "ref"), (33, 3, "ref"),
    (49, 1, "pallas"),      # K = 1 body: popped words unpack for feedback
])
def test_packed_service_matches_reference_and_unpacked(f, K, jax_backend):
    """ServiceConfig(packed=True): ingress, rings, eval set, serving and
    monitoring on packed words, bit for bit the reference's packed service
    and the port's unpacked one (same banks, reports, chunks, serves)."""
    n_classes = 10 if f == 49 else 3
    kw = dict(n_features=f, max_classes=n_classes, max_clauses=8,
              n_states=31)
    jc = JTMConfig(backend=jax_backend, **kw)
    tc = TTMConfig(backend="cuda", **kw)
    rows = _packed_rows(f, 150, seed=f)
    eval_rows = (rows[0][100:], rows[1][100:])
    s, T = ([2.0, 3.0, 3.9], [10, 15, 20]) if K == 3 else (2.0, 15)
    seeds = [5, 6, 7][:K]
    j = _tick_flow(JAX, jc, K, s, T, seeds, packed=True, rows=rows,
                   eval_rows=eval_rows)
    t = _tick_flow(TORCH, tc, K, s, T, seeds, packed=True, rows=rows,
                   eval_rows=eval_rows)
    _compare_flows(j, t)
    assert t["svc"].ss.buf.data_x.dtype == torch.int32
    assert t["svc"].ss.buf.data_x.shape[-1] == -(-f // 32)
    u = _tick_flow(TORCH, tc, K, s, T, seeds, packed=False, rows=rows,
                   eval_rows=eval_rows)
    assert torch.equal(u["svc"].ss.tm.ta_state, t["svc"].ss.tm.ta_state)
    for name in ("base", "served", "served_k", "acc"):
        assert _eq(u[name], t[name]), name
    for a, b in zip(u["reports"], t["reports"]):
        assert _eq(a.trained, b.trained)
        assert (a.accuracy is None) == (b.accuracy is None)
        if a.accuracy is not None:
            assert _eq(a.accuracy, b.accuracy)


def test_fleet_backpressure_counts():
    jc, tc = _cfgs()
    xs, ys = iris.load()
    out = []
    for pkg, cfg, mk_rt in ((JAX, jc, j_init_runtime),
                            (TORCH, tc, t_init_runtime)):
        fleet = pkg["Fleet"](cfg, pkg["init_state"](cfg, **pkg["dev"]),
                             mk_rt(cfg, s=3.0, T=15, **pkg["dev"]),
                             n_replicas=2, buffer_capacity=4, chunk=2,
                             seed=0, **pkg["dev"])
        got = [fleet.offer(0, xs[i], int(ys[i])) for i in range(5)]
        got.append(fleet.offer(1, xs[4], int(ys[4])))
        out.append((got, fleet.dropped, fleet.buffered))
    (jg, jd, jb), (tg, td, tb) = out
    assert jg == tg == [True] * 4 + [False, True]
    assert _eq(jd, td) and list(td) == [1, 0]
    assert _eq(jb, tb) and list(tb) == [4, 1]


@pytest.mark.parametrize("packed", [False, True])
def test_enqueue_rows_equals_sequential_pushes(packed):
    """One staged [K, B] block into K rings that are partly full and wrap:
    ring rows, labels, head, size and the accepted counts (short where a
    ring fills) equal the reference's sequential pushes."""
    f, K, cap, B = 33, 4, 6, 5
    rng = np.random.default_rng(3)
    head = np.array([0, 4, 5, 2], dtype=np.int32)
    size = np.array([0, 3, 6, 5], dtype=np.int32)
    counts = np.array([5, 2, 4, 3], dtype=np.int32)
    bits = rng.random((K, cap, f)) < 0.5
    data_x = j_packing.pack_bits_np(bits) if packed else bits
    data_y = rng.integers(0, 3, (K, cap)).astype(np.int32)
    xs_bits = rng.random((K, B, f)) < 0.5
    xs = j_packing.pack_bits_np(xs_bits) if packed else xs_bits
    ys = rng.integers(0, 3, (K, B)).astype(np.int32)
    from repro.core.online import SessionState as JSS
    from repro.core.tm import TMState as JTMState
    from repro.data.buffer import RingBuffer as JRing

    jss = JSS(tm=JTMState(jnp.zeros((K, 1))),
              buf=JRing(jnp.asarray(data_x), jnp.asarray(data_y),
                        jnp.asarray(head), jnp.asarray(size)),
              step=jnp.zeros(K, jnp.int32))
    jss, jacc = j_router._enqueue_rows(jss, B, xs, ys, counts)
    tx = (convert.words_from_numpy(data_x, "cpu") if packed
          else torch.from_numpy(data_x))
    tbuf = t_buf.RingBuffer(tx, torch.from_numpy(data_y),
                            torch.from_numpy(head), torch.from_numpy(size))
    tbuf, tacc = t_router._enqueue_rows(tbuf, xs, ys, counts)
    assert _eq(jacc, tacc.numpy()) and list(tacc.numpy()) == [5, 2, 0, 1]
    got_x = convert.words_to_numpy(tbuf.data_x) if packed else tbuf.data_x
    for w, g in ((jss.buf.data_x, got_x), (jss.buf.data_y, tbuf.data_y),
                 (jss.buf.head, tbuf.head), (jss.buf.size, tbuf.size)):
        assert _eq(w, np.asarray(g))


def test_pop_many_equals_pop_per_ring():
    rng = np.random.default_rng(5)
    K, cap = 3, 4
    ring = t_buf.RingBuffer(
        torch.from_numpy(rng.random((K, cap, 7)) < 0.5),
        torch.from_numpy(rng.integers(0, 3, (K, cap)).astype(np.int32)),
        torch.tensor([0, 3, 1], dtype=torch.int32),
        torch.tensor([2, 0, 4], dtype=torch.int32))
    out, x, y, ok = t_buf.pop_many(ring)
    for r in range(K):
        one = t_buf.RingBuffer(*(a[r] for a in ring))
        o1, x1, y1, ok1 = t_buf.pop(one)
        assert torch.equal(x[r], x1) and torch.equal(y[r], y1)
        assert bool(ok[r]) == bool(ok1)
        assert int(out.head[r]) == int(o1.head)
        assert int(out.size[r]) == int(o1.size)


def test_packed_router_routes_prepacked_rows_and_unpacked_refuses_them():
    _, tc = _cfgs(n_features=33)
    xs = np.random.default_rng(1).random((6, 33)) < 0.5

    def svc(packed):
        return TService(tc, t_init_state(tc, device="cpu"), TConfig(
            replicas=2, buffer_capacity=8, chunk=2, ingress_block=4,
            packed=packed), device="cpu")

    a, b = svc(True), svc(True)
    for i, x in enumerate(xs):
        assert _eq(a.submit_rows(x, i % 3),
                   b.submit_rows(j_packing.pack_bits_np(x), i % 3))
    for f in ("data_x", "data_y", "head", "size"):
        assert torch.equal(getattr(a.ss.buf, f), getattr(b.ss.buf, f))
    assert a.ss.buf.data_x.dtype == torch.int32
    u = svc(False)
    with pytest.raises(TypeError, match="packed"):
        u.submit_rows(j_packing.pack_bits_np(xs[0]), 0)
    assert list(u.buffered) == [0, 0]
    assert u.submit_rows(xs[0], 0).all()


def test_service_config_validates_port_lengths():
    _, tc = _cfgs()
    for bad in (dict(s=[1.0, 2.0]), dict(T=[5, 15])):
        with pytest.raises(ValueError, match="per-replica"):
            TService(tc, t_init_state(tc, device="cpu"),
                     TConfig(replicas=4, **bad), device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        TService(tc, t_init_state(tc, device="cpu"),
                 TConfig(replicas=2, seed=[1]), device="cpu")
    # a mesh must be the port's Mesh; a real one shards the fleet, which
    # then drains bitwise as the unsharded fleet
    with pytest.raises(TypeError, match="Mesh"):
        TFleet(tc, t_init_state(tc, device="cpu"),
               t_init_runtime(tc, device="cpu"), n_replicas=2, mesh=object(),
               device="cpu")
    xs, ys = _streams(4, 6)
    fleets = [TFleet(tc, t_init_state(tc, device="cpu"),
                     t_init_runtime(tc, s=3.0, T=15, device="cpu"),
                     n_replicas=4, chunk=4, seed=9, mesh=m, device="cpu")
              for m in (None, MESH)]
    for f in fleets:
        for i in range(6):
            f.offer_rows(xs[:, i], ys[:, i])
        assert list(f.drain(5)) == [5] * 4
    assert fleets[1].mesh is MESH and len(fleets[1].service._slabs) == 4
    _same_state(convert.session_state_to_numpy(fleets[0].ss), fleets[1].ss)
    assert _eq(fleets[0].service.rng_keys, fleets[1].service.rng_keys)


def _managers(jc, tc, K, oc_kw, seed):
    xs, ys = iris.load()
    jm = JFleetManager(jc, j_init_state(jc), j_init_runtime(jc, s=3.0, T=15),
                       xs[100:], ys[100:], n_replicas=K,
                       oc=JAdaptConfig(**oc_kw), seed=seed)
    tm = TFleetManager(tc, t_init_state(tc, device="cpu"),
                       t_init_runtime(tc, s=3.0, T=15, device="cpu"),
                       xs[100:], ys[100:], n_replicas=K,
                       oc=TAdaptConfig(**oc_kw), seed=seed, device="cpu")
    return jm, tm


def test_fleet_adapt_manager_per_replica_rollback():
    """A member whose bank is poisoned rolls back to its own known-good
    bank; the others are untouched. Histories, rollbacks and banks equal
    the reference's."""
    jc, tc = _cfgs()
    xs, ys = iris.load()
    K = 3
    jm, tm = _managers(jc, tc, K, dict(analyze_every=4,
                                       rollback_threshold=0.1,
                                       buffer_capacity=16, chunk=4),
                       [5, 6, 7])
    assert _eq(jm.offline_train(xs[:80], ys[:80], n_epochs=3),
               tm.offline_train(xs[:80], ys[:80], n_epochs=3))
    fresh = np.asarray(j_init_state(jc).ta_state)
    jp = np.asarray(jm.fleet.ss.tm.ta_state).copy()
    jp[0] = fresh
    jm.fleet.ss = jm.fleet.ss._replace(
        tm=jm.fleet.ss.tm._replace(ta_state=jnp.asarray(jp)))
    tp = tm.fleet.ss.tm.ta_state.clone()
    tp[0] = torch.from_numpy(fresh.copy())
    tm.fleet.ss = tm.fleet.ss._replace(tm=TTMState(tp))
    outs = [(jm.observe_rows(np.asarray(xs[80 + i]), int(ys[80 + i])),
             tm.observe_rows(np.asarray(xs[80 + i]), int(ys[80 + i])))
            for i in range(4)]
    for a, b in outs:
        assert (a is None) == (b is None) and (a is None or _eq(a, b))
    assert list(tm.rollbacks) == [1, 0, 0] and _eq(jm.rollbacks, tm.rollbacks)
    assert _eq(jm.fleet.ss.tm.ta_state, tm.fleet.ss.tm.ta_state.numpy())
    assert _eq(jm.analyze(), tm.analyze())
    assert len(jm.history) == len(tm.history)
    for (sj, aj), (st, at) in zip(jm.history, tm.history):
        assert _eq(sj, st) and _eq(aj, at)


def test_fleet_adapt_manager_per_replica_cadence():
    """Only members fed enough traffic hit their cadence, each on its own
    counter, as in the reference."""
    jc, tc = _cfgs()
    xs, ys = iris.load()
    jm, tm = _managers(jc, tc, 3, dict(analyze_every=3,
                                       rollback_threshold=0.5,
                                       buffer_capacity=16, chunk=4), 0)
    assert _eq(jm.offline_train(xs[:40], ys[:40], n_epochs=2),
               tm.offline_train(xs[:40], ys[:40], n_epochs=2))
    masks = [np.array([True, True, False])] * 3 + \
        [np.array([False, False, True])] * 3
    fired = []
    for i, mask in enumerate(masks):
        a = jm.observe_rows(np.asarray(xs[i]), int(ys[i]), mask)
        b = tm.observe_rows(np.asarray(xs[i]), int(ys[i]), mask)
        assert (a is None) == (b is None) and (a is None or _eq(a, b))
        fired.append(b is not None)
        assert _eq(jm._since, tm._since)
    assert fired == [False, False, True, False, False, True]
    assert _eq(jm.fleet.ss.tm.ta_state, tm.fleet.ss.tm.ta_state.numpy())
    assert _eq(jm.service.rng_keys, tm.service.rng_keys)


def test_online_adapt_manager_matches_reference():
    """The K = 1 face: scalar history and rollbacks, bit for bit."""
    from repro.serve.online_adapt import TMOnlineAdaptManager as JMgr
    from repro_torch.serve import TMOnlineAdaptManager as TMgr

    jc, tc = _cfgs()
    xs, ys = iris.load()
    oc = dict(analyze_every=5, rollback_threshold=0.02, buffer_capacity=8,
              chunk=3)
    jm = JMgr(jc, j_init_state(jc), j_init_runtime(jc, s=1.375, T=15),
              xs[100:], ys[100:], oc=JAdaptConfig(**oc), seed=4)
    tm = TMgr(tc, t_init_state(tc, device="cpu"),
              t_init_runtime(tc, s=1.375, T=15, device="cpu"), xs[100:],
              ys[100:], oc=TAdaptConfig(**oc), seed=4, device="cpu")
    assert jm.offline_train(xs[:30], ys[:30], 3) == \
        tm.offline_train(xs[:30], ys[:30], 3)
    for i in range(30, 60):
        assert jm.observe(xs[i], int(ys[i])) == tm.observe(xs[i], int(ys[i]))
    assert jm.history == tm.history and jm.rollbacks == tm.rollbacks
    assert jm.lost == tm.lost
    assert _eq(jm.serve(xs[:40]), tm.serve(xs[:40]))
    assert _eq(jm.session.ss.tm.ta_state, tm.session.ss.tm.ta_state.numpy())


# ---------------------------------------------------------------------------
# The replica-axis mesh: four CPU slabs against the JAX package's sharded
# run on four forced host devices
# ---------------------------------------------------------------------------

MESH_K = 8
MESH_S = [1.375, 3.0, 5.0, 2.0, 3.9, 1.375, 2.5, 4.0]
MESH_T = [5, 15, 10, 12, 20, 8, 15, 11]
MESH_SEEDS = [41 + r for r in range(MESH_K)]

JAX_MESH_SCRIPT = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[2])
    import jax
    import numpy as np
    from jax.sharding import Mesh
    assert len(jax.devices()) == 4, jax.devices()
    import test_torch_fleet as tf

    mesh = Mesh(np.array(jax.devices()), ("data",))
    jc, _ = tf._cfgs()
    out = {}
    for packed in (False, True):
        flow = tf._tick_flow(tf.JAX, jc, tf.MESH_K, tf.MESH_S, tf.MESH_T,
                             tf.MESH_SEEDS, packed=packed, mesh=mesh)
        for k, v in tf._flow_arrays(flow).items():
            out[f"{int(packed)}_{k}"] = v
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def _arr(x) -> np.ndarray:
    """A result as numpy in comparable bits: float32 and uint32 words as
    int32."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.array(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _flow_arrays(flow) -> dict:
    """Everything a :func:`_tick_flow` run produced, as numpy arrays."""
    svc = flow["svc"]
    ss = svc.ss
    K = svc.n_replicas
    out = {name: _arr(flow[name])
           for name in ("base", "served", "served_k", "acc")}
    out["accepted"] = _arr(np.stack(flow["accepted"]))
    for name, leaf in zip(("ta", "data_x", "data_y", "head", "size", "step"),
                          (ss.tm.ta_state, *ss.buf, ss.step)):
        out[name] = _arr(leaf)
    for name in ("rng_keys", "steps", "dropped", "buffered", "rollbacks",
                 "lost", "since_analysis"):
        out[name] = _arr(getattr(svc, name))
    reps = flow["reports"]
    out["trained"] = _arr(np.stack([r.trained for r in reps]))
    out["rolled"] = _arr(np.stack([r.rolled_back for r in reps]))
    out["report_acc"] = _arr(np.stack([
        np.full(K, np.nan, np.float32) if r.accuracy is None
        else np.asarray(r.accuracy, np.float32) for r in reps]))
    out["hist_steps"] = _arr(np.stack([np.asarray(h[0])
                                       for h in svc.history]))
    out["hist_acc"] = _arr(np.stack([np.asarray(h[1])
                                     for h in svc.history]))
    for f in flow["chunks"][0]._fields:
        out["chunk_" + f] = _arr(np.stack([_arr(getattr(c, f))
                                           for c in flow["chunks"]]))
    return out


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's mesh flows on four forced host devices (one
    subprocess for the module)."""
    tests = pathlib.Path(__file__).resolve().parent
    path = tmp_path_factory.mktemp("jax_mesh") / "fleet.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tests.parent / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", JAX_MESH_SCRIPT, str(path), str(tests)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
def test_fleet_mesh_per_replica_ports_match_jax_sharded(jax_sharded, packed):
    """K = 8 with per-replica s/T (each slab reads its rows of the ports),
    masked submits, backpressure, per-replica budgets, analysis and the
    policy, monitored chunks, fleet and per-member serves: sharded over
    four slabs, bitwise the unsharded port and the JAX package's sharded
    run."""
    _, tc = _cfgs()
    runs = [_flow_arrays(_tick_flow(TORCH, tc, MESH_K, MESH_S, MESH_T,
                                    MESH_SEEDS, packed=packed, mesh=m))
            for m in (None, MESH)]
    want = {k[2:]: v for k, v in jax_sharded.items()
            if k.startswith(f"{int(packed)}_")}
    assert set(want) == set(runs[1])
    for name, v in want.items():
        assert np.array_equal(runs[0][name], runs[1][name]), name
        assert np.array_equal(v, runs[1][name]), name
    assert len(runs[1]["hist_acc"]) > 0 and runs[1]["dropped"].sum() > 0
