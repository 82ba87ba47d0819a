"""The port's twin of ``tests/test_batch_dispatch.py``: the batch-first
kernel path and the backend dispatch layer, each held bit for bit to the
reference as well as to its own per-sample oracle.

The batch contract: ``clause_eval_batch(include, lits_B)`` equals stacking
the per-sample kernel over rows (``ref.clause_eval_loop``) on every
backend, for every shape (B = 1, B = 257, L across the 128-lane tile).
The port's backends are ``"ref"`` (plain) and ``"cuda"`` (on CPU tensors
each kernel wrapper runs its plain version); the reference's Pallas
kernels run in interpret mode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accuracy as j_acc
from repro.core import online as j_online
from repro.core import tm as j_tm
from repro.data import buffer as j_buf
from repro.data import iris
from repro.kernels import dispatch as j_dispatch
from repro.kernels import ref as j_ref
from repro_torch import convert
from repro_torch.core import accuracy as acc_mod
from repro_torch.core import feedback as fb_mod
from repro_torch.core import online as online_mod
from repro_torch.core import tm as tm_mod
from repro_torch.data import buffer as buf_mod
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.serve.online_adapt import (
    TMOnlineAdaptConfig, TMOnlineAdaptManager,
)

# (C, J, L, B): the reference's BATCH_SHAPES
BATCH_SHAPES = [
    (1, 2, 5, 1),
    (3, 16, 32, 7),
    (2, 6, 17, 257),
    (4, 33, 129, 33),
    (3, 16, 200, 128),
]
BACKENDS = ["ref", "cuda"]


def _rand_case(shape, seed=None):
    C, J, L, B = shape
    rng = np.random.default_rng(seed if seed is not None
                                else abs(hash(shape)) % 2**31)
    return rng.random((C, J, L)) < 0.3, rng.random((B, L)) < 0.5


@pytest.mark.parametrize("shape", BATCH_SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_clause_eval_batch_matches_per_sample_loop(shape, training):
    include, lits = _rand_case(shape)
    want = ref.clause_eval_loop(torch.from_numpy(include),
                                torch.from_numpy(lits), training=training)
    jwant = j_ref.clause_eval_loop(jnp.asarray(include), jnp.asarray(lits),
                                   training=training)
    assert np.array_equal(want.numpy(), np.asarray(jwant))
    for backend in BACKENDS:
        kb = dispatch.resolve(backend)
        got = kb.clause_eval_batch(torch.from_numpy(include),
                                   torch.from_numpy(lits), training=training)
        assert np.array_equal(want.numpy(), got.numpy()), backend


@pytest.mark.parametrize("shape", BATCH_SHAPES[:3])
def test_clause_eval_batch_ref_cuda_bit_parity(shape):
    include, lits = _rand_case(shape, seed=11)
    for training in (True, False):
        a = ref.clause_eval_batch(torch.from_numpy(include),
                                  torch.from_numpy(lits), training=training)
        b = ops.clause_eval_batch(torch.from_numpy(include),
                                  torch.from_numpy(lits), training=training)
        j = j_ref.clause_eval_batch(jnp.asarray(include), jnp.asarray(lits),
                                    training=training)
        assert np.array_equal(a.numpy(), b.numpy())
        assert np.array_equal(a.numpy(), np.asarray(j))


def test_clause_eval_batch_empty_clause_convention():
    include = torch.zeros((2, 4, 32), dtype=torch.bool)  # every clause empty
    lits = torch.from_numpy(np.random.default_rng(0).random((5, 32)) < 0.5)
    for backend in BACKENDS:
        kb = dispatch.resolve(backend)
        assert bool(kb.clause_eval_batch(include, lits, training=True).all())
        assert not bool(kb.clause_eval_batch(include, lits,
                                             training=False).any())
    assert ref.clause_eval_loop(include, lits[:0], training=True).shape \
        == (0, 2, 4)


def test_dispatch_registry_names_and_auto():
    assert set(dispatch.available()) >= {"ref", "cuda", "auto"}
    assert dispatch.resolve("ref").name == "ref"
    assert dispatch.resolve("cuda").name == "cuda"
    # TM_BACKEND overrides auto-resolution, as in the reference; otherwise
    # auto means the CUDA kernels (the reference: Pallas on TPU)
    assert dispatch.resolve("auto").name == os.environ.get("TM_BACKEND",
                                                           "cuda")
    assert set(dispatch.resolve("ref")._fields) == set(
        j_dispatch.resolve("ref")._fields)
    with pytest.raises(ValueError):
        dispatch.resolve("no-such-backend")


def test_dispatch_register_custom_backend():
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        return dispatch.resolve("ref")._replace(name="custom")

    dispatch.register("custom", factory)
    try:
        assert dispatch.resolve("custom").name == "custom"
        dispatch.resolve("custom")
        assert calls["n"] == 1  # factory result is cached
        cfg = tm_mod.TMConfig(n_features=4, max_classes=2, max_clauses=4,
                              backend="custom")
        assert cfg.backend == "custom"
    finally:
        dispatch._FACTORIES.pop("custom", None)
        dispatch._CACHE.pop("custom", None)


def test_config_rejects_unknown_backend_accepts_auto():
    with pytest.raises(ValueError):
        tm_mod.TMConfig(n_features=4, max_classes=2, max_clauses=4,
                        backend="nope")
    cfg = tm_mod.TMConfig(n_features=4, max_classes=2, max_clauses=4,
                          backend="auto")
    assert cfg.backend == "auto"


def _machine(seed, backend="ref", **rt_kw):
    """(reference cfg, state, rt), (port cfg, state, rt) from one key."""
    kw = dict(n_features=16, max_classes=3, max_clauses=16, n_states=50)
    jc = j_tm.TMConfig(**kw)
    tc = tm_mod.TMConfig(backend=backend, **kw)
    key = jax.random.PRNGKey(seed)
    js = j_tm.init_state(jc, key)
    ts = tm_mod.init_state(tc, convert.key_from_numpy(np.asarray(key), "cpu"),
                           device="cpu")
    assert np.array_equal(np.asarray(js.ta_state), ts.ta_state.numpy())
    return ((jc, js, j_tm.init_runtime(jc, **rt_kw)),
            (tc, ts, tm_mod.init_runtime(tc, device="cpu", **rt_kw)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_predict_batch_bitwise_matches_per_sample_predict(backend):
    """The acceptance contract: batch-first serving == per-sample serving
    (and == the reference's)."""
    (jc, js, jr), (tc, ts, tr) = _machine(2, backend)
    xs, _ = iris.load()
    batched = tm_mod.predict_batch(tc, ts, tr, torch.from_numpy(xs))
    rows = torch.stack([tm_mod.predict(tc, ts, tr, torch.from_numpy(x))
                        for x in xs])
    assert np.array_equal(batched.numpy(), rows.numpy())
    assert np.array_equal(batched.numpy(), np.asarray(
        j_tm.predict_batch(jc, js, jr, jnp.asarray(xs))))


def test_analyze_matches_per_sample_predictions():
    (jc, js, jr), (tc, ts, tr) = _machine(3)
    rng = np.random.default_rng(4)
    xs = rng.random((40, 16)) < 0.5
    ys = rng.integers(0, 3, 40).astype(np.int32)
    valid = rng.random(40) < 0.8
    preds = torch.stack([tm_mod.predict(tc, ts, tr, torch.from_numpy(x))
                         for x in xs]).numpy()
    ok = (preds == ys) & valid
    want = ok.sum() / max(valid.sum(), 1)
    got = float(acc_mod.analyze(tc, ts, tr, torch.from_numpy(xs),
                                torch.from_numpy(ys), torch.from_numpy(valid)))
    assert abs(got - want) < 1e-6
    assert got == float(j_acc.analyze(jc, js, jr, jnp.asarray(xs),
                                      jnp.asarray(ys), jnp.asarray(valid)))


def _buffer(xs, ys, n, capacity=16):
    """The port's ring holding rows 0..n-1, and the reference's."""
    buf = buf_mod.make(capacity, xs.shape[1], device="cpu")
    buf.data_x[:n] = torch.from_numpy(xs[:n].astype(bool))
    buf.data_y[:n] = torch.from_numpy(ys[:n].astype(np.int32))
    buf = buf._replace(size=torch.tensor(n, dtype=torch.int32))
    jb = j_buf.make(capacity, xs.shape[1])
    for i in range(n):
        jb, ok = j_buf.push(jb, jnp.asarray(xs[i], dtype=bool),
                            jnp.int32(ys[i]))
        assert bool(ok)
    return buf, jb


def _key(seed):
    key = jax.random.PRNGKey(seed)
    return key, convert.key_from_numpy(np.asarray(key), "cpu")


def test_consume_many_matches_serial_updates():
    """_consume_many == a hand loop of train_update over the same keys,
    and == the reference's drain."""
    (jc, js, jr), (tc, ts, tr) = _machine(5, s=3.0, T=15)
    xs, ys = iris.load()
    K = 8
    buf, jb = _buffer(xs, ys, K)
    ss = online_mod.SessionState(tm=ts, buf=buf,
                                 step=torch.tensor(0, dtype=torch.int32))
    jkey, key = _key(9)
    out, n, aux = online_mod._consume_many(tc, K, ss, tr, K, key)
    assert int(n) == K and int(out.buf.size) == 0
    ref_tm = ts
    for i, kk in enumerate(convert.key_from_numpy(
            np.asarray(jax.random.split(jkey, K)), "cpu")):
        ref_tm, _, _ = fb_mod.train_update(
            tc, ref_tm, tr, torch.from_numpy(xs[i].astype(bool)),
            torch.tensor(np.int32(ys[i])), kk)
    assert np.array_equal(out.tm.ta_state.numpy(), ref_tm.ta_state.numpy())
    assert aux.valid.shape == (K,) and bool(aux.valid.all())
    jss = j_online.SessionState(tm=js, buf=jb, step=jnp.int32(0))
    jout, jn, jaux = j_online._consume_many(jc, K, jss, jr, jnp.int32(K),
                                            jkey)
    assert int(jn) == K
    assert np.array_equal(out.tm.ta_state.numpy(),
                          np.asarray(jout.tm.ta_state))
    assert np.array_equal(aux.predicted.numpy(), np.asarray(jaux.predicted))


def test_consume_many_respects_limit_and_empty_buffer():
    (jc, js, jr), (tc, ts, tr) = _machine(6, s=3.0, T=15)
    xs, ys = iris.load()
    buf, _ = _buffer(xs, ys, 5)
    ss = online_mod.SessionState(tm=ts, buf=buf,
                                 step=torch.tensor(0, dtype=torch.int32))
    _, key = _key(10)
    # limit < buffered: stops at the limit, leaves the rest buffered
    out, n, _ = online_mod._consume_many(tc, 8, ss, tr, 3, key)
    assert int(n) == 3 and int(out.buf.size) == 2
    # chunk > buffered: consumes what exists, no more
    out2, n2, aux2 = online_mod._consume_many(tc, 8, out, tr, 8, key)
    assert int(n2) == 2 and int(out2.buf.size) == 0
    assert not bool(aux2.valid[2:].any())


def test_online_session_chunked_learn_counts():
    cfg = tm_mod.TMConfig(n_features=16, max_classes=3, max_clauses=16,
                          n_states=50)
    sess = online_mod.OnlineSession(
        cfg, tm_mod.init_state(cfg, device="cpu"),
        tm_mod.init_runtime(cfg, s=3.0, T=15, device="cpu"),
        buffer_capacity=64, chunk=8, device="cpu")
    jsess = j_online.OnlineSession(
        j_tm.TMConfig(n_features=16, max_classes=3, max_clauses=16,
                      n_states=50),
        j_tm.init_state(j_tm.TMConfig(n_features=16, max_classes=3,
                                      max_clauses=16, n_states=50)),
        j_tm.init_runtime(j_tm.TMConfig(n_features=16, max_classes=3,
                                        max_clauses=16, n_states=50),
                          s=3.0, T=15),
        buffer_capacity=64, chunk=8)
    xs, ys = iris.load()
    for i in range(20):
        assert sess.offer(xs[i], int(ys[i]))
        assert jsess.offer(xs[i], int(ys[i]))
    assert sess.learn_available(13) == 13      # crosses a partial chunk
    assert sess.buffered == 7
    assert sess.learn_available(100) == 7      # drains to empty
    assert sess.learn_available(4) == 0        # empty buffer trains nothing
    assert int(sess.ss.step) == 20
    for n in (13, 100, 4):
        jsess.learn_available(n)
    assert np.array_equal(sess.ss.tm.ta_state.numpy(),
                          np.asarray(jsess.ss.tm.ta_state))


def test_tm_online_adapt_manager_serves_and_rolls_back():
    cfg = tm_mod.TMConfig(n_features=16, max_classes=3, max_clauses=16,
                          n_states=50)
    rt = tm_mod.init_runtime(cfg, s=3.0, T=15, device="cpu")
    xs, ys = iris.load()
    mgr = TMOnlineAdaptManager(
        cfg, tm_mod.init_state(cfg, device="cpu"), rt, xs[100:], ys[100:],
        TMOnlineAdaptConfig(analyze_every=16, rollback_threshold=0.05,
                            chunk=8), device="cpu")
    base = mgr.offline_train(xs[:100], ys[:100], n_epochs=5)
    assert 0.0 <= base <= 1.0
    preds = mgr.serve(xs[:10])
    assert preds.shape == (10,)
    # Poisoned labels: shuffled ys force degradation -> rollback fires.
    rng = np.random.default_rng(0)
    for i in range(200):
        j = i % 100
        mgr.observe(xs[j], int(rng.integers(0, 3)))
        if mgr.rollbacks:
            break
    assert mgr.rollbacks >= 1
    assert len(mgr.history) >= 2


def test_forward_batch_matches_forward_rows():
    (jc, js, jr), (tc, ts, tr) = _machine(8, n_active_clauses=8)
    rng = np.random.default_rng(12)
    xs = rng.random((9, 16)) < 0.5
    for training in (True, False):
        cl_b, votes_b = tm_mod.forward_batch(tc, ts, tr, torch.from_numpy(xs),
                                             training=training)
        jcl, jv = j_tm.forward_batch(jc, js, jr, jnp.asarray(xs),
                                     training=training)
        assert np.array_equal(cl_b.numpy(), np.asarray(jcl))
        assert np.array_equal(votes_b.numpy(), np.asarray(jv))
        for i in range(9):
            cl, votes = tm_mod.forward(tc, ts, tr, torch.from_numpy(xs[i]),
                                       training=training)
            assert np.array_equal(cl_b[i].numpy(), cl.numpy())
            assert np.array_equal(votes_b[i].numpy(), votes.numpy())
