"""The port's residency layer against the JAX package's, bit for bit.

K = 6 logical replicas on R device slots (``ServiceConfig(resident=R)``
and ``"auto"``), the mirror of tests/test_residency.py with the JAX
``TMService`` as the oracle. The JAX side runs backend "ref"; the port
runs "cuda" (on CPU tensors: the kernels' plain versions) and "ref".
Every case compares the whole logical fleet -- the assembled banks,
rings, step counters and RNG keys, the policy FSM (since, best,
rollbacks, the host-side known-good banks), the analysis history, the
mirror, the resident set, the activation and eviction counts and the
plane width -- between the packages, and the port's residency service
against its always-resident twin (driven with budgets masked by
``buffered > 0``):

* the twin at R = 2, packed and unpacked, with served predictions;
* the explicit evict -> activate round trip, and the four refusals with
  the reference's messages;
* §5.3.2 rollbacks with ``_best_host``;
* every lane hot on two slots: batched moves against the synchronous
  oracle and the twin;
* the scoped evict (``take_lanes``) that leaves other lanes staged;
* ``"auto"``: the per-tick ``n_resident`` trajectory through grow and
  shrink;
* arbitrary submit / flush / tick / evict / activate / save-restore
  interleavings (hypothesis), with the FIFO model of the rings;
* ``ResidencyMap`` on seeded operation sequences, and the device moves
  of ``core/online.py`` (gather, issue / await, scatter, the mask-select
  activation; an issued gather is not a view of the plane).

* durable state: save -> restore -> continue equals never stopping at
  ``resident`` None, 3 and ``"auto"`` (packed and unpacked, both port
  backends), one checkpoint migrates across budgets (None, 1, 3), save
  lands staged ingress, a mismatched service is refused, and checkpoints
  cross from the JAX package to the port and back with
  ``resident="saved"``, continuing bitwise.

* the mesh: ``test_sharded_residency_matches_unsharded_twin`` lays the
  slots over four CPU slabs (``Mesh(["cpu"] * 4, ("data",))``; slot s on
  slab ``s // (R / 4)``) and holds the port bitwise against its unsharded
  always-resident twin and against the JAX package's sharded residency
  service on four forced host devices (one subprocess for the module,
  results through an ``.npz``): batched and synchronous moves, packed
  rows, ``"auto"`` with its granule, and a save -> restore across meshes.
"""
import os
import pathlib
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_state as j_init_state
from repro.core import online as j_online
from repro.core.online import SessionState as JSessionState
from repro.core.tm import TMState as JTMState
from repro.data.buffer import RingBuffer as JRing
from repro.serve import AdaptPolicy as JPolicy
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import residency as j_res
from repro_torch import tree as T
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_state as t_init_state
from repro_torch.core import online as t_online
from repro_torch.core.online import SessionState as TSessionState
from repro_torch.core.tm import TMState as TTMState
from repro_torch.data.buffer import RingBuffer as TRing
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import AdaptPolicy as TPolicy
from repro_torch.serve import ServiceConfig as TConfig
from repro_torch.serve import TMService as TService
from repro_torch.serve import residency as t_res

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # optional dev dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

K, CAP, BLOCK, CHUNK, F = 6, 8, 4, 4, 16

_RNG = np.random.default_rng(42)
EVAL_X = _RNG.random((24, F)) > 0.5
EVAL_Y = _RNG.integers(0, 3, 24)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several pytest
    workers at once, and torch's intra-op threads on top of them
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(mod, resident=None, *, backend=None, packed=False, seed=7,
         with_eval=True, analyze_every=8, batched=True, mesh=None):
    """The reference's test service (K = 6 on ``resident`` slots) in the
    JAX package (``mod="jax"``) or the port (``mod`` the port's backend,
    "cuda" or "ref")."""
    jax_side = mod == "jax"
    TM, Cfg, Pol = ((JTMConfig, JConfig, JPolicy) if jax_side
                    else (TTMConfig, TConfig, TPolicy))
    cfg = TM(n_features=F, max_classes=3, max_clauses=16, n_states=16,
             backend="ref" if jax_side else mod)
    sc = Cfg(replicas=K, buffer_capacity=CAP, chunk=CHUNK,
             ingress_block=BLOCK, packed=packed, s=3.0, T=15, seed=seed,
             resident=resident, batched_moves=batched, mesh=mesh,
             policy=Pol(analyze_every=analyze_every, rollback_threshold=0.1))
    ev = dict(eval_x=EVAL_X, eval_y=EVAL_Y) if with_eval else {}
    if jax_side:
        return JService(cfg, j_init_state(cfg), sc, **ev)
    return TService(cfg, t_init_state(cfg, device="cpu"), sc, device="cpu",
                    **ev)


def _np(x):
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim == 3 else x


def _fingerprint(svc, *, placement=True) -> dict:
    """The whole logical fleet as numpy in the reference's types. With
    ``placement`` also the residency bookkeeping (which replicas are
    resident, moves, plane width)."""
    ss = svc.ss
    out = {
        "ta": _np(ss.tm.ta_state), "x": _np(ss.buf.data_x),
        "y": _np(ss.buf.data_y), "head": _np(ss.buf.head),
        "size": _np(ss.buf.size), "step": _np(ss.step),
        "keys": np.asarray(svc.rng_keys), "steps": np.asarray(svc.steps),
        "since": svc.since_analysis, "rollbacks": svc.rollbacks,
        "lost": svc.lost, "best": svc._ps.best, "dropped": svc.dropped,
        "buffered": svc.buffered,
        "hist_steps": np.asarray([h[0] for h in svc.history]),
        "hist_acc": np.asarray([h[1] for h in svc.history]),
    }
    if svc._res is not None:
        out["best_host"] = svc._best_host
        if placement:
            out.update(resident=svc.resident, n_resident=svc.n_resident,
                       moves=np.asarray([svc._res.activations,
                                         svc._res.evictions]),
                       slot_of=svc._res.slot_of)
    else:
        out["best_host"] = (None if svc._ps.best_state is None
                            else _np(svc._ps.best_state.ta_state))
    return out


def _assert_same(a, b, msg="", placement=True):
    fa = _fingerprint(a, placement=placement)
    fb = _fingerprint(b, placement=placement)
    assert fa.keys() == fb.keys(), msg
    for k in fa:
        va, vb = fa[k], fb[k]
        if va is None or vb is None:
            assert va is None and vb is None, (k, msg)
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype, msg)
        assert np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), \
            (k, msg)


def _assert_logical(res, twin, msg=""):
    """A residency service against an always-resident one: the logical
    fleet only. A twin has no placement and no host-side best banks, and
    its analyses measure every member where residency measures the due
    ones (the history's accuracies differ by those nans)."""
    fa, fb = _fingerprint(res), _fingerprint(twin)
    for k in fb:
        if k in ("best_host", "hist_acc"):
            continue
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), \
            (k, msg)
    if twin._ps.best_state is not None:
        assert np.array_equal(res._best_host,
                              _np(twin._ps.best_state.ta_state)), msg


def _rows(n, seed):
    r = np.random.default_rng(seed)
    return [(r.random(F) > 0.5, int(r.integers(0, 3))) for _ in range(n)]


def _drive(svcs, n, seed, tick_every=4):
    for i, (x, y) in enumerate(_rows(n, seed)):
        for s in svcs:
            s.submit_rows(x, y)
        if i % tick_every == tick_every - 1:
            for s in svcs:
                s.tick()
    for s in svcs:
        s.flush()


def _lockstep(res, others, twins, x, y, budget=None, mask=None):
    """One submit to every service, then a tick: the residency services
    at ``budget``, the always-resident twins at it masked by the first
    residency service's ``buffered > 0``."""
    for s in res + others + twins:
        s.submit_rows(x, y, mask)
    res[0].flush()
    drive = res[0].buffered > 0
    b = res[0].chunk if budget is None else budget
    reps = [s.tick(budget) for s in res + others]
    for rep in reps[1:]:
        assert (rep.accuracy is None) == (reps[0].accuracy is None)
        if rep.accuracy is not None:
            assert np.array_equal(rep.accuracy, reps[0].accuracy,
                                  equal_nan=True)
    # a twin measures every member; residency leaves evicted members that
    # are not due at nan, so only what was trained and rolled back compare
    reps += [t.tick(np.where(drive, b, 0)) for t in twins]
    for rep in reps[1:]:
        assert np.array_equal(rep.trained, reps[0].trained)
        assert np.array_equal(rep.rolled_back, reps[0].rolled_back)


# ---------------------------------------------------------------------------
# The twin, explicit moves, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("packed", [False, True])
def test_residency_twin_bitwise(packed, backend):
    """K = 6 on 2 slots, ticking every 4 rows: the port equals the JAX
    residency service (placement included) and its own always-resident
    twin, across many evictions; served predictions too."""
    js = _svc("jax", 2, packed=packed)
    ts = _svc(backend, 2, packed=packed)
    twin = _svc(backend, None, packed=packed)
    r = np.random.default_rng(3)
    for i in range(40):
        x, y = r.random(F) > 0.5, int(r.integers(0, 3))
        for s in (js, ts, twin):
            s.submit_rows(x, y)
        if i % 4 == 3:
            ts.flush()
            js.flush()
            mask = ts.buffered > 0
            assert np.array_equal(mask, js.buffered > 0)
            js.tick()
            ts.tick()
            twin.tick(np.where(mask, twin.chunk, 0))
    assert ts._res.evictions > 10, "traffic never contended the slots"
    _assert_same(js, ts)
    _assert_logical(ts, twin)
    xs = _RNG.random((5, F)) > 0.5
    want = js.serve_replicas([0, 3, 5], xs)
    assert np.array_equal(ts.serve_replicas([0, 3, 5], xs), want)
    assert np.array_equal(twin.serve_replicas([0, 3, 5], xs), want)
    _assert_same(js, ts, "serving moved the fleet differently")


def test_explicit_evict_activate_roundtrip():
    js, ts = _svc("jax", 3, with_eval=False), _svc("cuda", 3,
                                                   with_eval=False)
    _drive([js, ts], 20, seed=5)
    before = _fingerprint(ts, placement=False)
    buffered = ts.buffered.copy()
    for s in (js, ts):
        s.evict(np.arange(K))
    assert ts.resident.sum() == 0
    assert np.array_equal(ts.buffered, buffered)      # nothing lost
    _assert_same(js, ts)
    assert np.array_equal(ts.activate([4, 1, 0]), js.activate([4, 1, 0]))
    assert set(np.nonzero(ts.resident)[0]) == {0, 1, 4}
    after = _fingerprint(ts, placement=False)
    for k in before:
        if before[k] is None:
            assert after[k] is None, k
            continue
        va, vb = np.asarray(before[k]), np.asarray(after[k])
        assert np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), k
    _assert_same(js, ts)


@pytest.mark.parametrize("batched", [True, False])
def test_evicted_snapshots_own_their_memory(batched):
    """Each evicted snapshot in the store holds host memory of its own,
    not a view of its cohort's gathered batch: one snapshot left in the
    store cannot keep the whole batch alive (on a card, the batch is
    page-locked)."""
    ts = _svc("cuda", 3, with_eval=False, batched=batched)
    _drive([ts], 20, seed=5)
    rids = np.nonzero(ts.resident)[0]
    assert len(rids) == 3
    ts.evict(rids)
    for rid in rids:
        for a in T.leaves(ts._res.store[int(rid)]):
            assert isinstance(a, np.generic) or a.flags.owndata, rid


def test_serve_replicas_matches_full_serve():
    js, ts = _svc("jax", with_eval=False), _svc("cuda", with_eval=False)
    _drive([js, ts], 20, seed=9)
    xs = _RNG.random((7, F)) > 0.5
    full = ts.serve(xs)
    assert np.array_equal(full, js.serve(xs))
    assert np.array_equal(ts.serve_replicas([5, 0, 2], xs), full[[5, 0, 2]])


def test_residency_rejects_wholesale_state_and_full_serve():
    """The four refusals, each with the reference's message."""
    for mod in ("jax", "cuda"):
        svc = _svc(mod, 2, with_eval=False)
        with pytest.raises(ValueError) as ei:
            svc.serve(_RNG.random((2, F)) > 0.5)
        assert "serve_replicas" in str(ei.value)
        assert "resident" in str(ei.value)
        with pytest.raises(ValueError, match="restore"):
            svc.ss = svc.ss
        with pytest.raises(ValueError, match="resident"):
            _svc(mod, 2, with_eval=False).offline_train(EVAL_X, EVAL_Y, 1)
    jcfg = JTMConfig(n_features=F, max_classes=3, max_clauses=16,
                     n_states=16)
    tcfg = TTMConfig(n_features=F, max_classes=3, max_clauses=16,
                     n_states=16)
    for make in (lambda: JService(jcfg, j_init_state(jcfg), JConfig(
                     replicas=K, resident=2, s=[3.0] * K, T=15, seed=0)),
                 lambda: TService(tcfg, t_init_state(tcfg, device="cpu"),
                                  TConfig(replicas=K, resident=2,
                                          s=[3.0] * K, T=15, seed=0),
                                  device="cpu")):
        with pytest.raises(ValueError, match="scalar s/T"):
            make()
    for bad in ("some", 0):
        with pytest.raises(ValueError, match="resident"):
            TService(tcfg, t_init_state(tcfg, device="cpu"),
                     TConfig(replicas=K, resident=bad), device="cpu")


def test_residency_policy_rollback_matches_twin():
    """The §5.3.2 FSM under residency (host-side best banks) transitions
    as the JAX residency service's and as the always-resident policy,
    rollbacks included."""
    js = _svc("jax", 2, analyze_every=4)
    ts = _svc("cuda", 2, analyze_every=4)
    twin = _svc("cuda", None, analyze_every=4)
    for x, y in _rows(60, 17):
        _lockstep([ts], [js], [twin], x, y)
    assert ts.rollbacks.any(), "no rollback fired"
    assert ts._best_host is not None
    _assert_same(js, ts)
    _assert_logical(ts, twin)


# ---------------------------------------------------------------------------
# Batched moves: multi-cohort superblocks, scoped evict, auto slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("packed", [False, True])
def test_multicohort_batched_matches_sync_oracle(packed, backend):
    """Every lane hot on 2 slots (3 cohorts a flush and a drain sweep):
    the batched moves land bitwise on the synchronous oracle, on the twin
    and on the JAX service's batched and synchronous paths."""
    js = _svc("jax", 2, packed=packed)
    js_sync = _svc("jax", 2, packed=packed, batched=False)
    batched = _svc(backend, 2, packed=packed)
    oracle = _svc(backend, 2, packed=packed, batched=False)
    twin = _svc(backend, None, packed=packed)
    assert batched._batched and not oracle._batched
    r = np.random.default_rng(11)
    svcs = (js, js_sync, batched, oracle, twin)
    for i in range(10):
        for _ in range(2):   # all K lanes hot every round
            x, y = r.random(F) > 0.5, int(r.integers(0, 3))
            for s in svcs:
                s.submit_rows(x, y)
        for s in svcs:
            s.tick(2)
    assert batched._res.evictions > 10, "slots were never contended"
    _assert_same(oracle, batched, "batched diverged from the oracle")
    _assert_same(js, batched, "batched diverged from the JAX service")
    _assert_same(js_sync, oracle, "sync diverged from the JAX sync path")
    _assert_logical(batched, twin, "batched diverged from the twin")


def test_scoped_evict_leaves_other_lanes_staged():
    """evict() lands only the named replicas' staged rows: other lanes
    stay staged (no block swap), and the evicted member's rows are in its
    spilled ring, as in the JAX service."""
    js, ts = _svc("jax", 2, with_eval=False), _svc("cuda", 2,
                                                   with_eval=False)
    for x, y in _rows(3, 2):
        js.submit_rows(x, y)
        ts.submit_rows(x, y)
    staged_before = ts.router.staged
    assert (staged_before == 3).all()
    buffered_before = ts.buffered.copy()
    flushes_before = ts.router.flushes
    js.evict([1])
    ts.evict([1])
    assert not ts.resident[1]
    staged = ts.router.staged
    assert staged[1] == 0, "the evicted lane must land before the spill"
    assert np.array_equal(staged[[0, 2, 3, 4, 5]],
                          staged_before[[0, 2, 3, 4, 5]])
    assert ts.router.flushes == flushes_before, "scoped path swapped a block"
    assert np.array_equal(ts.buffered, buffered_before)
    assert np.array_equal(js.router.staged, staged)
    snap = ts._res.store[1][0]
    jsnap = js._res.store[1][0]
    assert int(snap.buf.size) == 3
    for a, b in zip((snap.buf.data_x, snap.buf.data_y, snap.buf.head,
                     snap.buf.size), (jsnap.buf.data_x, jsnap.buf.data_y,
                                      jsnap.buf.head, jsnap.buf.size)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert int(np.asarray(ts.ss.buf.size)[1]) == 3   # flushes the rest
    _assert_same(js, ts)


def test_auto_resident_grow_shrink_trajectory():
    """resident='auto': dense traffic grows the plane, sparse traffic
    shrinks it through the hysteresis band; the per-tick n_resident
    trajectory, the EWMA and every re-partition equal the JAX service's,
    and the fleet stays bitwise the always-resident twin's."""
    js, ts = _svc("jax", "auto"), _svc("cuda", "auto")
    twin = _svc("cuda", None)
    assert ts.n_resident == js.n_resident == 2      # ceil(K / 4)
    r = np.random.default_rng(23)
    traj = []
    for n_lanes in [K] * 8 + [1] * 12:
        mask = np.zeros(K, dtype=bool)
        mask[:n_lanes] = True
        x, y = r.random(F) > 0.5, int(r.integers(0, 3))
        _lockstep([ts], [js], [twin], x, y, mask=mask)
        assert ts.n_resident == js.n_resident
        assert ts._res.ewma_active == js._res.ewma_active
        traj.append(ts.n_resident)
    grown = max(traj)
    assert grown > 2, "dense traffic never grew the plane"
    assert traj[-1] < grown, "sparse traffic never shrank the plane"
    assert ts.repartitions == js.repartitions >= 2
    _assert_same(js, ts)
    _assert_logical(ts, twin, "trajectory changed across re-partitions")


# ---------------------------------------------------------------------------
# Durable state: the save -> restore -> continue oracle, both directions
# ---------------------------------------------------------------------------


def _restore(mod, d, **kw):
    if mod == "jax":
        return JService.restore(d, eval_x=EVAL_X, eval_y=EVAL_Y, **kw)
    return TService.restore(d, eval_x=EVAL_X, eval_y=EVAL_Y, device="cpu",
                            **kw)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("resident", [None, 3, "auto"])
def test_save_restore_continuation_bitwise(packed, resident, tmp_path):
    """save -> restore -> continue == never stopping, in both packages
    side by side: banks, keys, rings, steps, policy, history, placement."""
    js, ts = _svc("jax", resident, packed=packed), _svc("cuda", resident,
                                                         packed=packed)
    _drive([js, ts], 20, seed=5)
    for s, d in ((js, tmp_path / "j"), (ts, tmp_path / "t")):
        s.save(str(d))
        # realign the writer's partitioning with a reader's (first R
        # resident: partitioning is not logical state)
        s.load(str(d))
    jo, to = _restore("jax", str(tmp_path / "j")), _restore(
        "cuda", str(tmp_path / "t"))
    assert to.sc.packed == packed and to.sc.resident == resident
    assert to._auto == (resident == "auto")
    # (lifetime move counts are not state: a restored map starts afresh)
    _assert_same(ts, to, "restore changed state", placement=False)
    _assert_same(js, ts)
    _drive([js, ts, jo, to], 30, seed=11)
    _assert_same(ts, to, "post-restore trajectories diverged",
                 placement=False)
    _assert_same(js, ts)
    _assert_same(jo, to)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("packed", [False, True])
def test_save_restore_continuation_backends(backend, packed, tmp_path):
    """The round trip at R = 2 on both port backends: trajectories and
    served predictions stay bitwise the JAX service's."""
    js, ts = _svc("jax", 2, packed=packed), _svc(backend, 2, packed=packed)
    _drive([js, ts], 12, seed=5)
    ts.save(str(tmp_path))
    ts.load(str(tmp_path))
    js.save(str(tmp_path / "j"))
    js.load(str(tmp_path / "j"))
    other = _restore("cuda", str(tmp_path))
    assert other.cfg.backend == backend
    _drive([js, ts, other], 12, seed=11)
    _assert_same(ts, other, f"{backend} restore diverged", placement=False)
    _assert_same(js, ts)
    xs = _RNG.random((4, F)) > 0.5
    want = js.serve_replicas(np.arange(K), xs)
    assert np.array_equal(ts.serve_replicas(np.arange(K), xs), want)
    assert np.array_equal(other.serve_replicas(np.arange(K), xs), want)


def test_restore_migrates_across_resident_budgets(tmp_path):
    """One checkpoint, any device budget: the logical fleet restored
    wholly resident, at R = 1 and at the saved R = 3 is the same, in the
    port as in the JAX package."""
    ts = _svc("cuda", 3)
    _drive([ts], 25, seed=5)
    ts.save(str(tmp_path))
    ported = [_restore("cuda", str(tmp_path), resident=r)
              for r in (None, 1, 3)]
    jaxed = [_restore("jax", str(tmp_path), resident=r)
             for r in (None, 1, 3)]
    assert [s.n_resident for s in ported] == [K, 1, 3]
    for t, j in zip(ported, jaxed):
        _assert_same(j, t, "the packages restore differently")
    for t in ported[1:]:
        _assert_logical(t, ported[0], "migration changed state")
    _drive(ported + jaxed, 12, seed=9)
    for t, j in zip(ported, jaxed):
        _assert_same(j, t, "the migrated fleets diverged")


def test_save_flushes_staged_ingress(tmp_path):
    """Rows staged but not flushed at save time are in the saved rings."""
    svc = _svc("cuda", 2, with_eval=False)
    svc.submit_rows(np.ones(F, dtype=bool), 1)
    assert svc.router.staged.sum() > 0 or svc.buffered.sum() > 0
    svc.save(str(tmp_path))
    other = TService.restore(str(tmp_path), device="cpu")
    assert np.array_equal(other.buffered, [1] * K)


def test_restore_rejects_mismatched_shape(tmp_path):
    svc = _svc("cuda", 2, with_eval=False)
    svc.save(str(tmp_path))
    wrong = _svc("cuda", None, packed=True, with_eval=False)
    with pytest.raises(ValueError, match="packed"):
        wrong.load(str(tmp_path))
    cfg = TTMConfig(n_features=F + 1, max_classes=3, max_clauses=16,
                    n_states=16)
    wide = TService(cfg, t_init_state(cfg, device="cpu"), TConfig(
        replicas=K, buffer_capacity=CAP, s=3.0, T=15, resident=2),
        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wide.load(str(tmp_path))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("resident", [2, "auto"])
def test_checkpoints_cross_between_packages(packed, resident, tmp_path):
    """A JAX residency checkpoint restores in the port as saved and a port
    one in the JAX package; each continues bitwise with the service that
    wrote it, placement included."""
    js, ts = _svc("jax", resident, packed=packed), _svc(
        "cuda", resident, packed=packed)
    _drive([js, ts], 20, seed=5)
    js.save(str(tmp_path / "j"))
    ts.save(str(tmp_path / "t"))
    js.load(str(tmp_path / "j"))
    ts.load(str(tmp_path / "t"))
    t_from_j = _restore("cuda", str(tmp_path / "j"))
    j_from_t = _restore("jax", str(tmp_path / "t"))
    assert t_from_j.sc.resident == resident == j_from_t.sc.resident
    for s in (t_from_j, j_from_t):
        _assert_same(js, s, "the crossing changed state", placement=False)
    _assert_same(t_from_j, j_from_t)
    _drive([js, ts, t_from_j, j_from_t], 24, seed=13)
    _assert_same(js, ts, "the writers diverged")
    _assert_same(t_from_j, j_from_t, "the crossed fleets diverged")
    _assert_same(js, t_from_j, "a crossed fleet diverged", placement=False)


# ---------------------------------------------------------------------------
# Hypothesis: arbitrary interleavings (FIFO model + the JAX service + twin)
# ---------------------------------------------------------------------------


def _row(uid: int):
    x = np.array([(uid >> b) & 1 for b in range(F)], dtype=bool)
    return x, uid % 3


def _uid(x: np.ndarray) -> int:
    return int(sum(int(v) << b for b, v in enumerate(x)))


def _rings(svc):
    """Per-replica assembled ring content, oldest first, as uids."""
    buf = svc.ss.buf
    data_x, head, size = (_np(buf.data_x), _np(buf.head), _np(buf.size))
    return [[_uid(data_x[r][(int(head[r]) + i) % CAP])
             for i in range(int(size[r]))] for r in range(K)]


class _Model:
    """Host-side reference: per-replica FIFO + conservation counters."""

    def __init__(self):
        self.queue = [[] for _ in range(K)]
        self.dropped = np.zeros(K, dtype=np.int64)

    def submit(self, uid, mask):
        ok = np.zeros(K, dtype=bool)
        for r in range(K):
            if not mask[r]:
                continue
            if len(self.queue[r]) >= CAP:
                self.dropped[r] += 1
            else:
                self.queue[r].append(uid)
                ok[r] = True
        return ok

    def drain(self, budget):
        for r in range(K):
            del self.queue[r][:min(int(budget[r]), len(self.queue[r]))]


if HAVE_HYPOTHESIS:
    _ops = st.lists(
        st.one_of(
            st.tuples(st.just("submit"), st.integers(1, 2 ** K - 1)),
            st.tuples(st.just("flush"), st.just(0)),
            st.tuples(st.just("tick"), st.integers(0, CHUNK)),
            st.tuples(st.just("evict"), st.integers(0, K - 1)),
            st.tuples(st.just("activate"), st.integers(0, K - 1)),
            st.tuples(st.just("saverestore"), st.just(0)),
        ),
        max_size=25,
    )

    @settings(max_examples=10, deadline=None)
    @given(ops_seq=_ops, seed=st.integers(0, 2 ** 31 - 1))
    def test_residency_interleavings_no_divergence_no_loss(ops_seq, seed):
        """Arbitrary submit/flush/tick/evict/activate/save-restore
        interleavings: the port's residency service equals the JAX one
        (placement included) and its never-evicted twin, and per-replica
        FIFO order and conservation hold on the assembled rings."""
        js = _svc("jax", 2, seed=seed, with_eval=False)
        ts = _svc("cuda", 2, seed=seed, with_eval=False)
        twin = _svc("cuda", None, seed=seed, with_eval=False)
        model = _Model()
        uid = 0
        with tempfile.TemporaryDirectory() as jdir, \
                tempfile.TemporaryDirectory() as tdir:
            for op, arg in ops_seq:
                if op == "submit":
                    uid += 1
                    x, y = _row(uid)
                    mask = np.array([(arg >> r) & 1 for r in range(K)],
                                    dtype=bool)
                    got = ts.submit_rows(x, y, mask)
                    assert np.array_equal(got, js.submit_rows(x, y, mask))
                    assert np.array_equal(got, twin.submit_rows(x, y, mask))
                    assert np.array_equal(got, model.submit(uid, mask))
                elif op == "flush":
                    for s in (js, ts, twin):
                        s.flush()
                elif op == "tick":
                    for s in (js, ts, twin):
                        s.flush()
                    mask = ts.buffered > 0
                    trained = ts.tick(arg).trained
                    budget = np.where(mask, arg, 0)
                    assert np.array_equal(trained, js.tick(arg).trained)
                    assert np.array_equal(trained, twin.tick(budget).trained)
                    model.drain(budget)
                elif op == "evict":
                    js.evict([arg])
                    ts.evict([arg])
                    twin.flush()   # evict lands staged ingress first
                elif op == "activate":
                    assert np.array_equal(ts.activate([arg]),
                                          js.activate([arg]))
                else:  # a self round trip mid-stream
                    js.save(jdir)
                    js.load(jdir)
                    ts.save(tdir)
                    ts.load(tdir)
                    twin.flush()   # save lands staged ingress first
            assert np.array_equal(ts.dropped, model.dropped)
            assert np.array_equal(ts.buffered,
                                  [len(q) for q in model.queue])
            _assert_same(js, ts, "the JAX service diverged")
            _assert_logical(ts, twin, "twin diverged")
            assert _rings(ts) == model.queue, "ring diverged from FIFO"


# ---------------------------------------------------------------------------
# ResidencyMap and the device moves against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_residency_map_matches_reference(seed):
    """The same seeded operation sequence (assign, release, touch,
    lru_victims with pinned slots, note_active, autotune_target at
    granules 1 and 4) on both maps: every return and every field agree."""
    r = np.random.default_rng(seed)
    n_rep = int(r.integers(4, 40))
    n_slot = int(r.integers(1, n_rep + 1))
    jm, tm = j_res.ResidencyMap(n_rep, n_slot), t_res.ResidencyMap(n_rep,
                                                                   n_slot)
    for _ in range(300):
        op = r.integers(0, 5)
        if op == 0:
            free = tm.free_slots()
            assert np.array_equal(free, jm.free_slots())
            out = np.nonzero(tm.slot_of < 0)[0]
            n = int(min(len(free), len(out), r.integers(0, 4)))
            if n:
                rids = r.choice(out, n, replace=False)
                slots = r.choice(free, n, replace=False)
                jm.assign(rids, slots)
                tm.assign(rids, slots)
        elif op == 1:
            occ = np.nonzero(tm.replica_of >= 0)[0]
            if len(occ):
                slots = r.choice(occ, int(r.integers(1, len(occ) + 1)),
                                 replace=False)
                assert np.array_equal(tm.release(slots),
                                      jm.release(slots))
        elif op == 2:
            slots = r.choice(n_slot, int(r.integers(1, n_slot + 1)),
                             replace=False)
            jm.touch(slots)
            tm.touch(slots)
        elif op == 3:
            occ = np.nonzero(tm.replica_of >= 0)[0]
            pinned = r.choice(occ, int(r.integers(0, len(occ) + 1)),
                              replace=False) if len(occ) else []
            n = int(r.integers(0, n_slot + 2))
            try:
                want = jm.lru_victims(n, pinned)
            except RuntimeError as e:
                with pytest.raises(RuntimeError, match="victims"):
                    tm.lru_victims(n, pinned)
                assert "victims" in str(e)
            else:
                assert np.array_equal(tm.lru_victims(n, pinned), want)
        else:
            n = int(r.integers(0, n_rep + 1))
            jm.note_active(n)
            tm.note_active(n)
            for g in (1, 4):
                assert tm.autotune_target(granule=g) == \
                    jm.autotune_target(granule=g)
        for f in ("slot_of", "replica_of", "last_use"):
            assert np.array_equal(getattr(tm, f), getattr(jm, f)), f
        assert (tm._clock, tm.activations, tm.evictions) == \
            (jm._clock, jm.activations, jm.evictions)
        assert np.array_equal(tm.resident_mask, jm.resident_mask)
        assert np.array_equal(np.float64(tm.ewma_active),
                              np.float64(jm.ewma_active), equal_nan=True)
    with pytest.raises(ValueError, match="resident"):
        t_res.ResidencyMap(3, 4)
    assert (t_res.EWMA_ALPHA, t_res.AUTO_HEADROOM) == \
        (j_res.EWMA_ALPHA, j_res.AUTO_HEADROOM)


def _planes(packed: bool, seed: int, R: int = 5):
    """One random (SessionState, keys) plane of R slots in both packages'
    types: the JAX tree of jnp arrays, the port's of CPU tensors."""
    r = np.random.default_rng(seed)
    ta = r.integers(1, 33, (R, 3, 16, 32)).astype(np.int8)
    if packed:
        x = r.integers(0, 2 ** 32, (R, CAP, 1), dtype=np.uint64).astype(
            np.uint32)
    else:
        x = r.random((R, CAP, F)) > 0.5
    y = r.integers(0, 3, (R, CAP)).astype(np.int32)
    head, size, step = (r.integers(0, CAP, R).astype(np.int32)
                        for _ in range(3))
    keys = r.integers(0, 2 ** 32, (R, 2), dtype=np.uint64).astype(np.uint32)
    jtree = (JSessionState(tm=JTMState(jnp.asarray(ta)),
                           buf=JRing(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(head), jnp.asarray(size)),
                           step=jnp.asarray(step)), jnp.asarray(keys))
    tx = x.view(np.int32) if packed else x
    ttree = (TSessionState(tm=TTMState(torch.from_numpy(ta.copy())),
                           buf=TRing(torch.from_numpy(tx.copy()),
                                     torch.from_numpy(y.copy()),
                                     torch.from_numpy(head.copy()),
                                     torch.from_numpy(size.copy())),
                           step=torch.from_numpy(step.copy())),
             torch.from_numpy(keys.astype(np.int64)))
    return jtree, ttree


def _same_tree(jtree, ttree):
    jl = [np.asarray(a) for a in jax.tree.leaves(jtree)]
    tl = T.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.dtype == np.uint32:
            b = b.astype(np.uint32) if b.dtype == np.int64 else b.view(
                np.uint32)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("packed", [False, True])
def test_device_moves_match_reference(packed):
    """gather_replicas, its issue / await halves, scatter_replicas and
    activate_replicas equal the reference's on one random plane; the
    issued gather is a copy, so a later in-place write to the plane does
    not reach it."""
    jtree, ttree = _planes(packed, seed=int(packed))
    idx = np.array([3, 0, 4])
    want = j_online.gather_replicas(jtree, idx)
    _same_tree(want, t_online.gather_replicas(ttree, idx))
    pending = t_online.gather_replicas_issue(ttree, idx)

    def flip(a):             # an in-place write, undone by a second one
        return a.logical_not_() if a.dtype == torch.bool else a.neg_()

    T.map(flip, ttree)
    _same_tree(want, t_online.gather_replicas_await(pending))
    T.map(flip, ttree)
    _same_tree(jtree, ttree)
    # scatter: stacked host values into rows [1, 2, 0]
    vals_j = j_online.gather_replicas(jtree, np.array([4, 3, 3]))
    vals_t = t_online.gather_replicas(ttree, np.array([4, 3, 3]))
    sidx = np.array([1, 2, 0])
    _same_tree(j_online.scatter_replicas(jtree, sidx, vals_j),
               t_online.scatter_replicas(ttree, sidx, vals_t))
    # the mask-select with a slot-indexed host plane
    mask = np.array([True, False, True, True, False])
    act_j = j_online.gather_replicas(jtree, np.array([4, 4, 0, 1, 2]))
    act_t = t_online.gather_replicas(ttree, np.array([4, 4, 0, 1, 2]))
    _same_tree(j_online.activate_replicas(jtree, act_j, mask),
               t_online.activate_replicas(ttree, act_t, mask))
    _same_tree(jtree, ttree)                     # both out of place


# ---------------------------------------------------------------------------
# The mesh: slots in slabs over four CPU devices, against the JAX package's
# sharded residency service on four forced host devices
# ---------------------------------------------------------------------------

MESH = Mesh(["cpu"] * 4, ("data",))
MESH_CASES = {"batched": dict(resident=4), "sync": dict(resident=4,
                                                         batched=False),
              "packed": dict(resident=4, packed=True),
              "auto": dict(resident="auto")}

JAX_MESH_SCRIPT = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[2])
    import jax
    import numpy as np
    from jax.sharding import Mesh
    assert len(jax.devices()) == 4, jax.devices()
    import test_torch_residency as tr

    mesh = Mesh(np.array(jax.devices()), ("data",))
    out = {}
    for name, kw in tr.MESH_CASES.items():
        svc = tr._svc("jax", mesh=mesh, **kw)
        tr._mesh_drive([svc], [])
        for k, v in tr._fingerprint(svc).items():
            if v is not None:
                out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def _mesh_drive(res, twins):
    """The reference's sharded-residency flow: 32 random rows into every
    replica, a flush and a tick every fourth, the twins ticked with
    budgets masked by the first residency service's ``buffered > 0``."""
    r = np.random.default_rng(3)
    for i in range(32):
        x, y = r.random(F) > 0.5, int(r.integers(0, 3))
        for s in res + twins:
            s.submit_rows(x, y)
        if i % 4 == 3:
            res[0].flush()
            mask = res[0].buffered > 0
            for s in res:
                s.tick()
            for t in twins:
                t.tick(np.where(mask, t.chunk, 0))


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded residency flows (one subprocess for the
    module)."""
    tests = pathlib.Path(__file__).resolve().parent
    path = tmp_path_factory.mktemp("jax_mesh") / "residency.npz"
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


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_sharded_residency_matches_unsharded_twin(jax_sharded, case):
    """The resident plane sharded in slabs over four CPU devices runs the
    evict/activate lifecycle bitwise equal to an unsharded always-resident
    fleet, to the unsharded residency service (placement included) and to
    the JAX package's sharded residency service."""
    kw = MESH_CASES[case]
    packed = kw.get("packed", False)
    res = _svc("cuda", mesh=MESH, **kw)
    plain = _svc("cuda", **kw)
    twin = _svc("cuda", None, packed=packed)
    _mesh_drive([res, plain], [twin])
    assert res._res.evictions > 0
    # an auto plane grown to the whole fleet (6) no longer divides the
    # mesh: one slab, as the reference replicates it
    assert len(res._slabs) == (4 if res.n_resident % 4 == 0 else 1)
    assert case == "auto" or len(res._slabs) == 4
    if case != "auto":     # the granule rounds the mesh's auto plane up
        _assert_same(plain, res)
    _assert_logical(res, twin)
    want = {k.split("/", 1)[1]: v for k, v in jax_sharded.items()
            if k.startswith(case + "/")}
    got = {k: v for k, v in _fingerprint(res).items() if v is not None}
    assert set(want) == set(got)
    for k, v in want.items():
        g = np.asarray(got[k])
        assert np.array_equal(v, g, equal_nan=v.dtype.kind == "f"), k
    xs = _RNG.random((5, F)) > 0.5
    assert np.array_equal(res.serve_replicas([5, 0, 3], xs),
                          twin.serve_replicas([5, 0, 3], xs))


def test_sharded_residency_checkpoint_crosses_meshes(tmp_path):
    """A sharded residency service saves the full-K layout: restored
    without a mesh (and a service without one restored onto the mesh),
    each continues bitwise as the service that never stopped."""
    a = _svc("cuda", 4, mesh=MESH)
    b = _svc("cuda", 4)
    _drive([a, b], 24, seed=8)
    a.save(str(tmp_path / "a"))
    b.save(str(tmp_path / "b"))
    ev = dict(eval_x=EVAL_X, eval_y=EVAL_Y)
    a2 = TService.restore(str(tmp_path / "a"), device="cpu", **ev)
    b2 = TService.restore(str(tmp_path / "b"), mesh=MESH, **ev)
    assert len(a2._slabs) == 1 and len(b2._slabs) == 4
    _drive([a, b, a2, b2], 24, seed=9)
    # a restore partitions the fleet afresh (replicas 0..R-1 in the
    # slots): the restored pair shares its placement, the logical fleet
    # is the one that never stopped
    _assert_same(a, b)
    _assert_same(a2, b2)
    _assert_same(a, a2, placement=False)
