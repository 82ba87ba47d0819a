"""The port's runtime-tunable serving against the JAX package's, bit for
bit: the mirror of tests/test_tunable.py with the JAX ``TMService`` as the
oracle (K = 4, F = 16, C = 3, J = 8, N = 32).

Both services train the same way (``_train``: 24 submit + tick steps),
then calibrate on the eval set: scores, polarity-balanced ranks and
integer weights must agree bitwise. Predictions and per-request
``evaluated`` counts must agree at budgets {1, 0.5, 0.25} x weight_bits
{0, 4} x early exit {off, group 1, 2, 3, 8}, packed and unpacked, through
``serve`` and ``serve_replicas``; so must the class-mask early exit, the
three error cases and the adapt rule's budget trajectory. The JAX side
runs backend "ref"; the port runs "cuda" (on CPU tensors: K7's plain
version) and "ref". The ``resident=2`` cases of tests/test_tunable.py
(K = 4 on two device slots) run beside the JAX residency service: full
budget through ``serve_replicas`` cohorts equal to plain serve, and ranks
that survive eviction and activation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_state as j_init_state
from repro.core import tm as j_tm
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import TunableConfig as JTunable
from repro.serve import tunable as j_tun
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import init_state as t_init_state
from repro_torch.core import tm as t_tm
from repro_torch.serve import ServiceConfig as TConfig
from repro_torch.serve import TMService as TService
from repro_torch.serve import TunableConfig as TTunable
from repro_torch.serve import tunable as t_tun

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # optional dev dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

K, F, C, J, N = 4, 16, 3, 8, 32

_RNG = np.random.default_rng(11)
X = _RNG.random((40, F)) > 0.5
Y = _RNG.integers(0, C, 40).astype(np.int32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jsvc(*, packed=False, tunable=None, replicas=K, resident=None):
    cfg = JTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N)
    sc = JConfig(replicas=replicas, buffer_capacity=64, chunk=8, s=3.0, T=10,
                 seed=0, packed=packed, tunable=tunable, resident=resident)
    return JService(cfg, j_init_state(cfg), sc, eval_x=X, eval_y=Y)


def _tsvc(backend="cuda", *, packed=False, tunable=None, replicas=K,
          resident=None):
    cfg = TTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N,
                    backend=backend)
    sc = TConfig(replicas=replicas, buffer_capacity=64, chunk=8, s=3.0, T=10,
                 seed=0, packed=packed, tunable=tunable, resident=resident)
    return TService(cfg, t_init_state(cfg, device="cpu"), sc, eval_x=X,
                    eval_y=Y, device="cpu")


def _train(svc, n=24):
    R = svc.n_replicas
    for i in range(n):
        svc.submit_rows(X[i % len(X)], np.full(R, Y[i % len(Y)]))
        svc.tick()
    svc.flush()
    return svc


def _tj(tc: dict):
    return JTunable(**tc), TTunable(**tc)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One trained checkpoint per packing, from each package, and the
    plain serve that is the full-budget oracle."""
    out = {}
    for packed in (False, True):
        js, ts = _train(_jsvc(packed=packed)), _train(_tsvc(packed=packed))
        assert np.array_equal(np.asarray(js.ss.tm.ta_state),
                              ts.ss.tm.ta_state.numpy())
        dj = str(tmp_path_factory.mktemp("jax"))
        dt = str(tmp_path_factory.mktemp("port"))
        js.save(dj)
        ts.save(dt)
        base = js.serve(X)
        assert np.array_equal(base, ts.serve(X))
        out[packed] = (dj, dt, base)
    return out


def _pair(trained, packed, tc: dict, backend="cuda", resident=None):
    """A JAX and a port service with the tunable config ``tc``, each
    loaded from its own package's trained checkpoint and calibrated."""
    dj, dt, _ = trained[packed]
    jt, tt = _tj(tc)
    js = _jsvc(packed=packed, tunable=jt, resident=resident)
    js.load(dj)
    ts = _tsvc(backend, packed=packed, tunable=tt, resident=resident)
    ts.load(dt)
    sj, st_ = js.calibrate(), ts.calibrate()
    assert st_.dtype == np.int32 and np.array_equal(sj, st_)
    return js, ts


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("weight_bits", [0, 4])
def test_calibration_matches_jax(trained, packed, weight_bits):
    js, ts = _pair(trained, packed, dict(weight_bits=weight_bits))
    assert np.array_equal(js.tuner.score, ts.tuner.score)
    assert ts.tuner.order.dtype == np.int32
    assert np.array_equal(js.tuner.order, ts.tuner.order)
    if weight_bits:
        assert ts.tuner.weights.dtype == np.int32
        assert np.array_equal(js.tuner.weights, ts.tuner.weights)
    else:
        assert js.tuner.weights is None and ts.tuner.weights is None


def test_calibration_k1_matches_jax(tmp_path):
    """K = 1 calibrates through clause_scores (one machine's plane)."""
    tc = dict(budget=0.5, weight_bits=4)
    jt, tt = _tj(tc)
    js = _train(_jsvc(tunable=jt, replicas=1))
    ts = _train(_tsvc(tunable=tt, replicas=1))
    assert np.array_equal(js.calibrate(), ts.calibrate())
    assert np.array_equal(js.tuner.order, ts.tuner.order)
    assert np.array_equal(js.tuner.weights, ts.tuner.weights)
    assert np.array_equal(js.serve(X), ts.serve(X))
    pj, aj = js.serve(X, budget=0.25, return_aux=True)
    pt, at = ts.serve(X, budget=0.25, return_aux=True)
    assert np.array_equal(pj, pt) and np.array_equal(aj.sel, at.sel)
    assert np.array_equal(aj.evaluated, at.evaluated)


@pytest.mark.parametrize("budget", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("weight_bits", [0, 4])
@pytest.mark.parametrize("group", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_budgeted_serve_matches_jax(trained, budget, weight_bits, group,
                                    packed):
    tc = dict(budget=budget, weight_bits=weight_bits,
              early_exit=group is not None, group=group or 16)
    js, ts = _pair(trained, packed, tc)
    assert np.array_equal(js.serve(X), ts.serve(X))   # the live budget
    pj, aj = js.serve(X, budget=budget, return_aux=True)
    pt, at = ts.serve(X, budget=budget, return_aux=True)
    assert pt.dtype == np.int32 and at.evaluated.dtype == np.int32
    assert np.array_equal(pj, pt)
    assert (aj.budget, aj.m) == (at.budget, at.m)
    assert np.array_equal(aj.sel, at.sel)
    assert np.array_equal(aj.evaluated, at.evaluated)
    # serve_replicas on a subset: those rows of serve, both packages
    sub = [3, 1]
    rj, bj = js.serve_replicas(sub, X, budget=budget, return_aux=True)
    rt, bt = ts.serve_replicas(sub, X, budget=budget, return_aux=True)
    assert np.array_equal(rj, rt) and np.array_equal(rt, pt[sub])
    assert np.array_equal(bj.evaluated, bt.evaluated)
    assert np.array_equal(bt.evaluated, at.evaluated[sub])
    # per-member batches
    xs_m = np.stack([X[r:r + 10] for r in range(len(sub))])
    assert np.array_equal(js.serve_replicas(sub, xs_m),
                          ts.serve_replicas(sub, xs_m))


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("packed", [False, True])
def test_full_budget_equals_plain_serve(trained, backend, packed):
    """Budget 1.0, unit weights, no early exit: the plain serve path bit
    for bit (the reference's contract), on both port backends."""
    _, _, base = trained[packed]
    _, ts = _pair(trained, packed, dict(budget=1.0), backend)
    assert not ts.tuner.active
    assert np.array_equal(ts.serve(X), base)
    assert np.array_equal(ts.serve(X, budget=1.0), base)
    assert np.array_equal(ts.serve_replicas(np.arange(K), X, budget=1.0),
                          base)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("packed", [False, True])
def test_full_budget_under_residency_equals_plain_serve(trained, backend,
                                                        packed):
    """resident=2: budget 1.0 through ``serve_replicas`` cohorts (members
    activated two at a time) equals the plain serve, in the port as in
    the JAX residency service."""
    _, _, base = trained[packed]
    js, ts = _pair(trained, packed, dict(budget=1.0), backend, resident=2)
    assert ts._res is not None and ts.n_resident == 2
    assert np.array_equal(js.tuner.order, ts.tuner.order)
    got = ts.serve_replicas(np.arange(K), X, budget=1.0)
    assert np.array_equal(got, base)
    assert np.array_equal(js.serve_replicas(np.arange(K), X, budget=1.0),
                          got)
    assert np.array_equal(ts.resident, js.resident)


def test_ranks_survive_eviction():
    """Rankings are host-side per-replica state: serving after every
    member was evicted and activated again uses the same ranks, with the
    same predictions and evaluated counts as the JAX residency service."""
    tc = dict(budget=0.5, early_exit=True, group=2)
    js = _train(_jsvc(resident=2, tunable=JTunable(**tc)))
    ts = _train(_tsvc(resident=2, tunable=TTunable(**tc)))
    assert np.array_equal(js.calibrate(), ts.calibrate())
    first, aux = ts.serve_replicas(np.arange(K), X, return_aux=True)
    jfirst, jaux = js.serve_replicas(np.arange(K), X, return_aux=True)
    assert np.array_equal(first, jfirst)
    assert np.array_equal(aux.evaluated, jaux.evaluated)
    for r in range(K):
        assert np.array_equal(ts.serve_replicas([r], X[:2]),
                              js.serve_replicas([r], X[:2]))
    assert ts._res.evictions == js._res.evictions >= K
    again = ts.serve_replicas(np.arange(K), X)
    assert np.array_equal(first, again)
    assert np.array_equal(js.serve_replicas(np.arange(K), X), again)


@pytest.mark.parametrize("group", [1, 2, 3, 8])
def test_early_exit_predictions_equal_no_exit(group):
    """The early-exit host loop against the JAX one: predictions equal
    early exit off, evaluated counts equal the reference's."""
    jc = JTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N)
    tc = TTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N,
                   backend="cuda")
    rng = np.random.default_rng(14)
    ta = rng.integers(1, 2 * N + 1, (K, C, J, 2 * F)).astype(np.int8)
    order = np.stack([np.stack([rng.permutation(J) for _ in range(C)])
                      for _ in range(K)]).astype(np.int32)
    weights = rng.integers(1, 8, (K, C, J)).astype(np.int32)
    jst, tst = j_tm.TMState(jnp.asarray(ta)), t_tm.TMState(torch.from_numpy(ta))
    jrt, trt = j_tm.init_runtime(jc), t_init_runtime(tc, device="cpu")
    xs = X[None]
    for m in (J, J // 2, 1):
        base, ev0 = t_tun.predict_pruned_replicated_host(
            tc, tst, trt, torch.from_numpy(xs), order, weights, m)
        got, ev = t_tun.predict_pruned_replicated_host(
            tc, tst, trt, torch.from_numpy(xs), order, weights, m,
            group=group)
        wj, evj = j_tun.predict_pruned_replicated_host(
            jc, jst, jrt, xs, order, weights, m, group=group)
        assert np.array_equal(base, got) and np.array_equal(got, wj)
        assert np.array_equal(ev, evj)
        assert (ev0 == m).all() and ev.max() <= m


def test_early_exit_respects_class_mask():
    jc = JTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N)
    tc = TTMConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N)
    cmask = np.array([True, False, True])
    jrt = j_tm.init_runtime(jc)._replace(class_mask=jnp.asarray(cmask))
    trt = t_init_runtime(tc, device="cpu")._replace(
        class_mask=torch.from_numpy(cmask))
    rng = np.random.default_rng(16)
    ta = rng.integers(1, 2 * N + 1, (K, C, J, 2 * F)).astype(np.int8)
    order = np.stack([np.stack([rng.permutation(J) for _ in range(C)])
                      for _ in range(K)]).astype(np.int32)
    tst = t_tm.TMState(torch.from_numpy(ta))
    p0, _ = t_tun.predict_pruned_replicated_host(
        tc, tst, trt, torch.from_numpy(X[None]), order, None, J)
    p1, e1 = t_tun.predict_pruned_replicated_host(
        tc, tst, trt, torch.from_numpy(X[None]), order, None, J, group=2)
    pj, ej = j_tun.predict_pruned_replicated_host(
        jc, j_tm.TMState(jnp.asarray(ta)), jrt, X[None], order, None, J,
        group=2)
    assert np.array_equal(p0, p1) and np.array_equal(p1, pj)
    assert np.array_equal(e1, ej)
    assert not (p0 == 1).any()                  # masked class never wins
    with pytest.raises(ValueError, match="outside"):
        t_tun.predict_pruned_replicated_host(
            tc, tst, trt, torch.from_numpy(X[None]), order + 1, None, J)


def test_uncalibrated_and_unconfigured_errors(trained):
    _, dt, _ = trained[False]
    plain = _tsvc()
    plain.load(dt)
    with pytest.raises(ValueError, match="tunable"):
        plain.serve(X, budget=0.5)
    with pytest.raises(ValueError, match="tunable"):
        plain.calibrate()
    armed = _tsvc(tunable=TTunable(budget=0.5))
    armed.load(dt)
    with pytest.raises(ValueError, match="calibrate"):
        armed.serve(X)
    with pytest.raises(ValueError, match="budget"):
        plain.serve(X, return_aux=True)
    with pytest.raises(ValueError, match="budget"):
        plain.serve_replicas([0], X, return_aux=True)
    with pytest.raises(ValueError, match="replica ids"):
        plain.serve_replicas([K], X)


def test_load_of_uncalibrated_checkpoint_resets_tuner(trained):
    _, dt, _ = trained[False]
    svc = _tsvc(tunable=TTunable(budget=1.0))
    svc.load(dt)
    svc.calibrate()
    assert svc.tuner.calibrated
    svc.load(dt)                     # saved without a tuner
    assert not svc.tuner.calibrated


def test_adapt_trajectory_matches_jax(trained):
    """The queue-depth rule sheds and recovers the budget, tick for tick
    as the JAX service does."""
    tc = dict(budget=1.0, adapt=True, min_budget=0.25, high_water=4,
              low_water=1, step=2.0)
    js, ts = _pair(trained, False, tc)
    for i in range(12):
        js.submit_rows(X[i], np.full(K, Y[i]))
        ts.submit_rows(X[i], np.full(K, Y[i]))
    traj = []
    for svc in (js, ts):
        svc.tick(max_points=1)       # a deep queue after a starved drain
        out = [svc.tuner.budget]
        for _ in range(10):
            svc.tick()               # the queue drains; the budget climbs
            out.append(svc.tuner.budget)
        traj.append(out)
    assert traj[0] == traj[1]
    assert traj[1][0] == 0.5 and traj[1][-1] == 1.0
    assert np.array_equal(np.asarray(js.ss.tm.ta_state),
                          ts.ss.tm.ta_state.numpy())


def test_tuner_survives_save_restore(trained, tmp_path):
    """A calibrated port service saves its ranks, weights and live
    budget; the restored one serves the same bits, and so does the JAX
    package restoring the same checkpoint."""
    _, ts = _pair(trained, False, dict(budget=0.5, weight_bits=4))
    ts.tuner.budget = 0.25
    preds = ts.serve(X)
    d = str(tmp_path / "ckpt")
    ts.save(d)
    t2 = TService.restore(d, eval_x=X, eval_y=Y, device="cpu")
    assert t2.tuner.calibrated and t2.tuner.budget == 0.25
    assert np.array_equal(t2.tuner.order, ts.tuner.order)
    assert np.array_equal(t2.tuner.weights, ts.tuner.weights)
    assert np.array_equal(t2.serve(X), preds)
    j2 = JService.restore(d, eval_x=X, eval_y=Y)
    assert j2.tuner.budget == 0.25
    assert np.array_equal(j2.tuner.order, ts.tuner.order)
    assert np.array_equal(j2.serve(X), preds)
    assert np.array_equal(t2.serve(X, budget=1.0), ts.serve(X, budget=1.0))


def test_weights_from_scores_and_m_for_budget_match_jax():
    rng = np.random.default_rng(13)
    score = rng.integers(-50, 50, (K, C, J)).astype(np.int32)
    assert t_tun.weights_from_scores(score, 0) is None
    for bits in (1, 4, 7):
        w = t_tun.weights_from_scores(score, bits)
        assert w.dtype == np.int32
        assert np.array_equal(w, j_tun.weights_from_scores(score, bits))
    for b in (1.0, 0.5, 0.25, 0.125, 1e-9, 0.3):
        assert t_tun.m_for_budget(b, J) == j_tun.m_for_budget(b, J)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            t_tun.m_for_budget(bad, J)


if HAVE_HYPOTHESIS:

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           shape=st.tuples(st.integers(1, 4), st.integers(2, 12)),
           balanced=st.booleans())
    def test_property_ranking_matches_jax(seed, shape, balanced):
        """Every clause ranked once, deterministic, ties toward the lower
        index, and the JAX package's ranking bit for bit (plain and
        polarity-balanced)."""
        c, j = shape
        rng = np.random.default_rng(seed)
        score = rng.integers(-100, 100, (c, j)).astype(np.int32)
        pol = np.where(np.arange(j) % 2 == 0, 1, -1) if balanced else None
        o1 = t_tun.rank_from_scores(score, pol)
        assert np.array_equal(o1, j_tun.rank_from_scores(score, pol))
        assert np.array_equal(o1, t_tun.rank_from_scores(score.copy(), pol))
        assert np.array_equal(np.sort(o1, axis=-1),
                              np.broadcast_to(np.arange(j), (c, j)))
        if not balanced:
            for s, o in zip(score, o1):
                for a, b in zip(o[:-1], o[1:]):
                    assert (s[a] > s[b]) or (s[a] == s[b] and a < b)
