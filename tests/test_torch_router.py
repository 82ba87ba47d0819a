"""The port's BatchRouter ingress: nothing lost, nothing reordered.

The twin of tests/test_router.py on ``repro_torch``: conservation and FIFO
order per replica under arbitrary submit / submit_rows / flush / drain /
tick interleavings (against a host FIFO model and, op by op, the JAX
service), the block-flush counts, host-side acceptance against the
outstanding-rows mirror, the broadcast rules, the mirror surviving a
raising ``on_chunk``, stable double-buffered blocks, ``take_lanes``
(the scoped take of ``TMService.evict``), the packed and unpacked dtype
routing, the history limit, the port-length check and analysis without
an eval set. Rows carry a unique id in their feature bits, so a
reordering cannot hide.
"""
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_state as j_init_state
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro_torch.core import TMConfig, init_state
from repro_torch.kernels.packing import pack_bits_np
from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService
from repro_torch.serve.router import BatchRouter

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # optional dev dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

K, CAP, BLOCK, CHUNK, F = 3, 6, 3, 4, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return TMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16)


def _make_service(seed=0, packed=False):
    return TMService(_cfg(), init_state(_cfg(), device="cpu"), ServiceConfig(
        replicas=K, buffer_capacity=CAP, chunk=CHUNK, ingress_block=BLOCK,
        s=3.0, T=15, seed=seed, packed=packed), device="cpu")


def _make_jax_service(seed=0):
    cfg = JTMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16)
    return JService(cfg, j_init_state(cfg), JConfig(
        replicas=K, buffer_capacity=CAP, chunk=CHUNK, ingress_block=BLOCK,
        s=3.0, T=15, seed=seed))


def _row(uid: int):
    """A unique datapoint: uid's bits as features (16 bits = plenty)."""
    x = np.array([(uid >> b) & 1 for b in range(F)], dtype=bool)
    return x, uid % 3


def _uid(x: np.ndarray) -> int:
    return int(sum(int(v) << b for b, v in enumerate(x)))


def _device_queue(svc, r):
    """Replica r's ring content, oldest first, as uids."""
    buf = svc.ss.buf
    data_x = np.asarray(buf.data_x[r])
    head = int(buf.head[r])
    size = int(buf.size[r])
    return [_uid(data_x[(head + i) % CAP]) for i in range(size)]


class _Model:
    """Host-side reference: per-replica FIFO + conservation counters."""

    def __init__(self):
        self.queue = [[] for _ in range(K)]   # accepted, not yet trained
        self.submitted = np.zeros(K, dtype=np.int64)
        self.dropped = np.zeros(K, dtype=np.int64)
        self.trained = np.zeros(K, dtype=np.int64)

    def submit(self, r, uid) -> bool:
        self.submitted[r] += 1
        if len(self.queue[r]) >= CAP:
            self.dropped[r] += 1
            return False
        self.queue[r].append(uid)
        return True

    def drain(self, budget):
        out = []
        for r in range(K):
            n = min(int(budget[r]), len(self.queue[r]))
            del self.queue[r][:n]
            self.trained[r] += n
            out.append(n)
        return np.asarray(out)


def _check(svc, model):
    """Conservation + order invariants (order read after a forced flush,
    so staged rows are visible in the rings)."""
    np.testing.assert_array_equal(svc.buffered,
                                  [len(q) for q in model.queue])
    np.testing.assert_array_equal(svc.dropped, model.dropped)
    np.testing.assert_array_equal(
        model.submitted, model.trained + svc.buffered + model.dropped)
    svc.flush()
    for r in range(K):
        assert _device_queue(svc, r) == model.queue[r], (
            f"replica {r}: ring diverged from the FIFO model")


if HAVE_HYPOTHESIS:
    _ops = st.lists(
        st.one_of(
            st.tuples(st.just("submit"), st.integers(0, K - 1)),
            st.tuples(st.just("submit_rows"), st.integers(1, 2 ** K - 1)),
            st.tuples(st.just("flush"), st.just(0)),
            st.tuples(st.just("drain"), st.integers(0, 2 * CAP)),
            st.tuples(st.just("tick"), st.integers(0, CHUNK)),
        ),
        max_size=30,
    )

    @settings(max_examples=12, deadline=None)
    @given(ops_seq=_ops, seed=st.integers(0, 2 ** 31 - 1))
    def test_router_no_loss_no_reorder(ops_seq, seed):
        """Arbitrary submit/submit_rows/flush/drain/tick interleavings:
        per-replica FIFO order and conservation hold, and every return
        value and the final banks and keys equal the JAX service's."""
        svc, jsvc = _make_service(seed), _make_jax_service(seed)
        model = _Model()
        uid = 0
        for op, arg in ops_seq:
            if op == "submit":
                uid += 1
                x, y = _row(uid)
                got = svc.submit(arg, x, y)
                assert got == model.submit(arg, uid)
                assert got == jsvc.submit(arg, x, y)
            elif op == "submit_rows":
                uid += 1
                x, y = _row(uid)
                mask = np.array([(arg >> r) & 1 for r in range(K)],
                                dtype=bool)
                got = svc.submit_rows(x, y, mask)
                want = np.array([model.submit(r, uid) if mask[r] else False
                                 for r in range(K)])
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got,
                                              jsvc.submit_rows(x, y, mask))
            elif op == "flush":
                np.testing.assert_array_equal(svc.flush(), jsvc.flush())
            elif op == "drain":
                got = svc.drain(arg)
                np.testing.assert_array_equal(got, model.drain([arg] * K))
                np.testing.assert_array_equal(got, jsvc.drain(arg))
            else:  # tick (no eval set: drains + cadence only)
                rep = svc.tick(arg)
                np.testing.assert_array_equal(rep.trained,
                                              model.drain([arg] * K))
                np.testing.assert_array_equal(rep.trained,
                                              jsvc.tick(arg).trained)
                assert rep.accuracy is None
        _check(svc, model)
        np.testing.assert_array_equal(svc.ss.tm.ta_state.numpy(),
                                      np.asarray(jsvc.ss.tm.ta_state))
        np.testing.assert_array_equal(svc.rng_keys, np.asarray(jsvc.rng_keys))
        assert svc.router.flushes == jsvc.router.flushes


def test_router_block_flush_counts():
    """Auto-flush fires when a staging lane fills: N submits per replica
    cost ceil(N / B_ingress) dispatches, and an explicit flush is a no-op
    when nothing is staged."""
    svc = _make_service()
    uid = 0
    for _ in range(BLOCK):        # fill every lane exactly once
        uid += 1
        x, y = _row(uid)
        svc.submit_rows(x, y)
    assert svc.router.flushes == 1
    np.testing.assert_array_equal(svc.router.staged, [0] * K)
    svc.flush()
    assert svc.router.flushes == 1
    uid += 1
    x, y = _row(uid)
    svc.submit(0, x, y)
    svc.flush()
    assert svc.router.flushes == 2
    np.testing.assert_array_equal(svc.buffered, [BLOCK + 1, BLOCK, BLOCK])


def test_router_rejects_against_mirror_not_device():
    """Acceptance is decided on the host: a full buffer (ring + staged)
    rejects at once although nothing reached the device yet."""
    svc = _make_service()
    for i in range(CAP):
        x, y = _row(i + 1)
        assert svc.submit(0, x, y)
    x, y = _row(99)
    assert not svc.submit(0, x, y)            # full purely from staging
    np.testing.assert_array_equal(svc.dropped, [1, 0, 0])
    svc.drain(2)                               # frees two slots
    assert svc.submit(0, x, y)
    np.testing.assert_array_equal(svc.buffered, [CAP - 1, 0, 0])


def test_submit_rows_broadcast_contract():
    """[f] and [1, f] features (and scalar / [1] labels) fan out to all K
    replicas."""
    svc = _make_service()
    x, y = _row(5)
    for xs, ys in [(x, y), (x[None], np.asarray([y])),
                   (np.broadcast_to(x, (K, F)), np.full(K, y))]:
        np.testing.assert_array_equal(svc.submit_rows(xs, ys), [True] * K)
    svc.flush()
    for r in range(K):
        assert _device_queue(svc, r) == [5, 5, 5]


def test_mirror_survives_on_chunk_exception():
    """A callback raising mid-drain leaves device state, the occupancy
    mirror and acceptance consistent (no phantom backpressure)."""
    svc = _make_service()
    for i in range(CAP):
        x, y = _row(i + 1)
        assert svc.submit(0, x, y)

    class Boom(Exception):
        pass

    calls = []

    def boom(aux):
        calls.append(aux)
        raise Boom

    with pytest.raises(Boom):
        svc.drain(CAP, on_chunk=boom)   # CHUNK < CAP: raises on chunk 1
    assert len(calls) == 1
    np.testing.assert_array_equal(svc.buffered, [CAP - CHUNK, 0, 0])
    assert svc.buffered[0] == int(svc.ss.buf.size[0])
    x, y = _row(99)
    assert svc.submit(0, x, y)
    assert svc.drain(2 * CAP)[0] == CAP - CHUNK + 1


def test_take_block_returns_stable_double_buffered_arrays():
    """A taken block stays frozen while producers keep staging into the
    other one; the swap alternates blocks."""
    r = BatchRouter(K, F, capacity=CAP, block=BLOCK)
    dev = np.zeros(K, dtype=np.int64)
    full = np.ones(K, dtype=bool)
    for uid in (1, 2):
        x, y = _row(uid)
        acc, blocked = r.stage_rows(np.broadcast_to(x, (K, F)),
                                    np.full(K, y), full, dev)
        assert acc.all() and not blocked.any()
    xs, ys, counts = r.take_block()
    snap_x, snap_y = xs.copy(), ys.copy()
    np.testing.assert_array_equal(counts, [2] * K)
    for uid in (7, 8, 9):
        x, y = _row(uid)
        r.stage_rows(np.broadcast_to(x, (K, F)), np.full(K, y), full, dev)
    np.testing.assert_array_equal(xs, snap_x)
    np.testing.assert_array_equal(ys, snap_y)
    xs2, _, counts2 = r.take_block()
    np.testing.assert_array_equal(counts2, [3] * K)
    assert _uid(xs2[0, 0]) == 7 and _uid(xs2[0, 2]) == 9


def test_take_lanes_scopes_to_named_replicas():
    """take_lanes pulls only the named lanes: other lanes stay staged, no
    block swap happens, the taken rows come in submission order and are
    copies."""
    r = BatchRouter(K, F, capacity=CAP, block=BLOCK)
    dev = np.zeros(K, dtype=np.int64)
    full = np.ones(K, dtype=bool)
    for uid in (1, 2):
        x, y = _row(uid)
        acc, _ = r.stage_rows(np.broadcast_to(x, (K, F)), np.full(K, y),
                              full, dev)
        assert acc.all()
    taken = r.take_lanes([2, 0])
    assert taken is not None
    xs, ys, counts = taken
    np.testing.assert_array_equal(counts, [2, 2])
    for lane in range(2):
        assert [_uid(xs[lane, c]) for c in range(2)] == [1, 2]
    np.testing.assert_array_equal(r.staged, [0, 2, 0])   # lane 1 untouched
    assert r.flushes == 0
    assert r.take_lanes([0, 2]) is None
    x, y = _row(5)
    r.stage_rows(np.broadcast_to(x, (K, F)), np.full(K, y), full, dev)
    assert [_uid(xs[0, c]) for c in range(2)] == [1, 2]  # a copy
    xs2, _, counts2 = r.take_block()
    np.testing.assert_array_equal(counts2, [1, 3, 1])
    assert _uid(xs2[1, 0]) == 1 and _uid(xs2[0, 0]) == 5


if HAVE_HYPOTHESIS:
    _stage_take_ops = st.lists(
        st.one_of(
            st.tuples(st.just("stage"), st.integers(1, 2 ** K - 1)),
            st.tuples(st.just("take"), st.just(0)),
            st.tuples(st.just("lanes"), st.integers(1, 2 ** K - 1)),
        ),
        max_size=40,
    )

    @settings(max_examples=30, deadline=None)
    @given(ops_seq=_stage_take_ops)
    def test_router_stage_take_interleaving(ops_seq):
        """Arbitrary stage / take_block / take_lanes interleavings: per
        replica, the concatenation of everything taken is exactly the
        accepted rows in submission order."""
        r = BatchRouter(K, F, capacity=10 ** 6, block=BLOCK)
        dev = np.zeros(K, dtype=np.int64)
        staged = [[] for _ in range(K)]
        uid = 0

        def took(i, got):
            assert staged[i][:len(got)] == got, f"replica {i} out of order"
            del staged[i][:len(got)]

        for op, arg in ops_seq:
            mask = np.array([(arg >> i) & 1 for i in range(K)], dtype=bool)
            if op == "stage":
                uid += 1
                x, y = _row(uid)
                acc, blocked = r.stage_rows(
                    np.broadcast_to(x, (K, F)), np.full(K, y), mask, dev)
                np.testing.assert_array_equal(acc | blocked, mask)
                for i in np.nonzero(acc)[0]:
                    staged[i].append(uid)
            elif op == "take":
                blk = r.take_block()
                if blk is None:
                    assert not any(staged), "rows staged but take gave None"
                    continue
                xs, _, counts = blk
                for i in range(K):
                    took(i, [_uid(xs[i, c]) for c in range(int(counts[i]))])
            else:
                rids = np.nonzero(mask)[0]
                got = r.take_lanes(rids)
                if got is None:
                    assert not any(staged[i] for i in rids)
                    continue
                xs, _, counts = got
                for j, i in enumerate(rids):
                    took(i, [_uid(xs[j, c]) for c in range(int(counts[j]))])
        while (blk := r.take_block()) is not None:
            xs, _, counts = blk
            for i in range(K):
                took(i, [_uid(xs[i, c]) for c in range(int(counts[i]))])
        assert not any(staged)


def test_packed_submit_routes_prepacked_uint32_rows():
    """On a packed service, already-packed uint32 word rows pass the
    staging boundary as they are, landing the same rings as bool rows."""
    svc_bool, svc_words = (_make_service(packed=True),
                           _make_service(packed=True))
    for uid in (5, 9, 1034):
        x, y = _row(uid)
        np.testing.assert_array_equal(
            svc_bool.submit_rows(x, y),
            svc_words.submit_rows(pack_bits_np(x[None])[0], y))
    svc_bool.flush(), svc_words.flush()
    for name in ("data_x", "data_y", "head", "size"):
        assert torch.equal(getattr(svc_bool.ss.buf, name),
                           getattr(svc_words.ss.buf, name))
    assert svc_words.ss.buf.data_x.dtype == torch.int32   # the port's words


def test_unpacked_submit_rejects_uint32_rows():
    """uint32 rows into an unpacked service are an error, not a silent
    bool cast."""
    svc = _make_service()
    x, y = _row(3)
    packed_row = np.zeros(1, dtype=np.uint32)
    packed_row[0] = 3
    with pytest.raises(TypeError, match="packed"):
        svc.submit_rows(packed_row, y)
    np.testing.assert_array_equal(svc.buffered, [0] * K)
    assert svc.submit_rows(x, y).all()


def test_service_history_limit_bounds_growth():
    """history_limit keeps only the most recent analysis entries."""
    xs = np.stack([_row(i + 1)[0] for i in range(8)])
    ys = np.asarray([_row(i + 1)[1] for i in range(8)], dtype=np.int32)

    def build(limit):
        return TMService(_cfg(), init_state(_cfg(), device="cpu"),
                         ServiceConfig(replicas=K, buffer_capacity=CAP,
                                       chunk=CHUNK, s=3.0, T=15,
                                       history_limit=limit),
                         eval_x=xs, eval_y=ys, device="cpu")

    unbounded, bounded = build(None), build(3)
    for _ in range(7):
        unbounded.analyze(), bounded.analyze()
    assert len(unbounded.history) == 7
    assert len(bounded.history) == 3
    for (s_u, a_u), (s_b, a_b) in zip(unbounded.history[-3:],
                                      bounded.history):
        np.testing.assert_array_equal(s_u, s_b)
        np.testing.assert_array_equal(a_u, a_b)
    with pytest.raises(ValueError, match="history_limit"):
        build(0)


def test_service_config_validates_port_lengths():
    """Per-replica s/T sequences must match ``replicas`` at construction."""
    for bad in (dict(s=[1.0, 2.0]), dict(T=[5, 15])):
        with pytest.raises(ValueError, match="per-replica"):
            TMService(_cfg(), init_state(_cfg(), device="cpu"),
                      ServiceConfig(replicas=4, **bad), device="cpu")


def test_service_requires_eval_set_for_analysis():
    svc = _make_service()
    with pytest.raises(ValueError):
        svc.analyze()
    rep = svc.tick(2)                 # a plain drain without an eval set
    assert rep.accuracy is None
    assert isinstance(svc.policy, AdaptPolicy)
    assert torch.as_tensor(svc.rt.s).ndim == 0
