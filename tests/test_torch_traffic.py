"""The port's traffic harness against the JAX package's.

* ``make_scripts`` is bitwise the reference's for the same seed (every
  standard schedule and one with every knob turned);
* a threaded run on the port's service, replayed from one thread through
  a fresh port service AND through a fresh JAX service, lands on the same
  fingerprint (TA banks, RNG keys as uint32, steps, policy) as the live
  run: steady, fault-injected and packed. A JAX threaded run replays
  through the port to the JAX fingerprint;
* per-replica FIFO and conservation under real backpressure, the
  script-count guard, the oracle's teeth (another seed diverges), and the
  tunable service logging its live budget per tick.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_state as j_init_state
from repro.serve import AdaptPolicy as JPolicy
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import traffic as j_traffic
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_state as t_init_state
from repro_torch.serve import (SCENARIOS, AdaptPolicy, Scenario,
                               ServiceConfig, TMService, TunableConfig,
                               make_script, make_scripts,
                               replay_single_caller, run_threaded)
from repro_torch.serve.traffic import (fingerprint, fingerprints_equal,
                                       slo_summary)

K, F, NC = 2, 16, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(n=24, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(n, F)).astype(bool),
            rng.integers(0, NC, size=n).astype(np.int32))


def _service(seed=0, packed=False, tunable=None):
    cfg = TTMConfig(n_features=F, max_classes=NC, max_clauses=8, n_states=16)
    ex, ey = _dataset(n=16, seed=99)
    return TMService(cfg, t_init_state(cfg, device="cpu"), ServiceConfig(
        replicas=K, buffer_capacity=256, chunk=8, ingress_block=4,
        packed=packed, s=3.0, T=15, seed=seed,
        policy=AdaptPolicy(analyze_every=16), tunable=tunable),
        eval_x=ex, eval_y=ey, device="cpu")


def _jservice(seed=0, packed=False):
    cfg = JTMConfig(n_features=F, max_classes=NC, max_clauses=8, n_states=16)
    ex, ey = _dataset(n=16, seed=99)
    return JService(cfg, j_init_state(cfg), JConfig(
        replicas=K, buffer_capacity=256, chunk=8, ingress_block=4,
        packed=packed, s=3.0, T=15, seed=seed,
        policy=JPolicy(analyze_every=16)), eval_x=ex, eval_y=ey)


SCRIPT_CASES = [SCENARIOS["steady"], SCENARIOS["bursty_drift"],
                SCENARIOS["fault_injected"],
                Scenario(name="knobs", points=80, burst=8, burst_gap_s=0.001,
                         label_delay=5, introduce_class=2, introduce_at=0.5,
                         drift_at=0.75, drift_shift=1, probe_every=3)]


@pytest.mark.parametrize("sc", SCRIPT_CASES, ids=lambda s: s.name)
def test_make_scripts_bitwise_reference(sc):
    xs, ys = _dataset(n=64)
    got = make_scripts(sc, xs, ys, NC, 3, seed=3)
    want = j_traffic.make_scripts(j_traffic.Scenario(**vars(sc)), xs, ys,
                                  NC, 3, seed=3)
    for a, b in zip(got, want):
        for f in ("x", "y", "gap_s"):
            va, vb = getattr(a, f), getattr(b, f)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
        assert (a.label_delay, a.probe_every) == (b.label_delay,
                                                  b.probe_every)
    one = make_script(sc, xs, ys, NC, producer=1, seed=3)
    assert np.array_equal(one.x, got[1].x)


def test_run_threaded_rejects_script_count_mismatch():
    xs, ys = _dataset()
    scripts = make_scripts(SCENARIOS["steady"], xs, ys, NC, K + 1)
    with pytest.raises(ValueError, match="producer scripts"):
        run_threaded(_service(), scripts, scenario=SCENARIOS["steady"])


REPLAY_CASES = [
    ("steady", Scenario(name="steady", points=48, probe_every=4), False),
    ("fault_injected", Scenario(name="fault", points=32, fault_at=24,
                                fault_fraction=0.25, fault_stuck=1,
                                probe_every=0), False),
    ("packed", Scenario(name="steady", points=32, probe_every=8), True),
]


@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda c: c[0])
def test_threaded_run_replays_in_both_packages(case):
    """Threaded port run -> single-caller replay through the port and
    through the JAX package: three equal fingerprints."""
    _, sc, packed = case
    xs, ys = _dataset(n=32)
    scripts = make_scripts(sc, xs, ys, NC, K, seed=11)
    live = _service(seed=5, packed=packed)
    result = run_threaded(live, scripts, scenario=sc, pace=0.0)
    assert result.conserved() and result.tick_budget is None
    twin = _service(seed=5, packed=packed)
    replay_single_caller(twin, scripts, result, scenario=sc)
    jtwin = _jservice(seed=5, packed=packed)
    j_traffic.replay_single_caller(jtwin, scripts, result, scenario=sc)
    fp = fingerprint(live)
    assert fp["keys"].dtype == np.uint32
    assert fingerprints_equal(fp, fingerprint(twin))
    assert fingerprints_equal(fp, j_traffic.fingerprint(jtwin))
    if sc.fault_at is not None:
        assert result.fault_tick is not None
        assert bool(live.rt.ta_or_mask.any()) and bool(twin.rt.ta_or_mask
                                                       .any())
    s = slo_summary(result)
    assert s["conserved"] and s["offers_per_s"] > 0


def test_jax_recorded_run_replays_in_the_port():
    """A schedule recorded on the JAX service replays through the port to
    the JAX live run's fingerprint."""
    sc = Scenario(name="fault", points=32, fault_at=16, fault_fraction=0.25,
                  fault_stuck=1, probe_every=4)
    xs, ys = _dataset(n=32)
    scripts = j_traffic.make_scripts(j_traffic.Scenario(**vars(sc)), xs, ys,
                                     NC, K, seed=11)
    live = _jservice(seed=5)
    result = j_traffic.run_threaded(live, scripts,
                                    scenario=j_traffic.Scenario(**vars(sc)),
                                    pace=0.0)
    twin = _service(seed=5)
    replay_single_caller(twin, scripts, result, scenario=sc)
    assert fingerprints_equal(j_traffic.fingerprint(live), fingerprint(twin))


def test_replay_diverges_for_different_seed():
    sc = Scenario(name="steady", points=16, probe_every=0)
    xs, ys = _dataset(n=32)
    scripts = make_scripts(sc, xs, ys, NC, K, seed=11)
    live = _service(seed=5)
    result = run_threaded(live, scripts, scenario=sc, pace=0.0)
    twin = _service(seed=6)
    replay_single_caller(twin, scripts, result, scenario=sc)
    assert not fingerprints_equal(fingerprint(live), fingerprint(twin))


def test_threaded_producers_fifo_and_conservation():
    """Producer threads against the tick loop on a service small enough
    that lanes fill and rings overflow: per-replica FIFO survives on the
    ring and every offer is accounted for."""
    CAP, BLOCK, CHUNK, N = 6, 3, 4, 120
    cfg = TTMConfig(n_features=F, max_classes=NC, max_clauses=8, n_states=16)
    svc = TMService(cfg, t_init_state(cfg, device="cpu"), ServiceConfig(
        replicas=K, buffer_capacity=CAP, chunk=CHUNK, ingress_block=BLOCK,
        s=3.0, T=15, seed=0), device="cpu")

    def _uid_row(uid):
        return np.array([(uid >> b) & 1 for b in range(F)], dtype=bool)

    def _uid(x):
        return int(sum(int(v) << b for b, v in enumerate(x)))

    accepted_uids = [[] for _ in range(K)]
    errors = []
    barrier = threading.Barrier(K + 1)

    def producer(p):
        try:
            barrier.wait()
            for i in range(N):
                uid = p * N + i + 1
                if svc.submit(p, _uid_row(uid), uid % NC):
                    accepted_uids[p].append(uid)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,), daemon=True)
               for p in range(K)]
    for t in threads:
        t.start()
    barrier.wait()
    while any(t.is_alive() for t in threads):
        svc.tick()
    for t in threads:
        t.join()
    assert not errors, errors
    accepted = np.asarray([len(a) for a in accepted_uids], dtype=np.int64)
    np.testing.assert_array_equal(accepted + svc.dropped,
                                  np.full(K, N, dtype=np.int64))
    trained = svc.steps.astype(np.int64)
    np.testing.assert_array_equal(accepted, trained + svc.buffered)
    svc.flush()
    buf = svc.ss.buf
    for r in range(K):
        head, size = int(buf.head[r]), int(buf.size[r])
        ring = [_uid(buf.data_x[r][(head + i) % CAP].numpy())
                for i in range(size)]
        assert ring == accepted_uids[r][int(trained[r]):]


def test_traffic_result_logs_budget():
    """The tunable service under the harness: the live budget is logged
    per tick and stays inside [min_budget, budget]."""
    tc = TunableConfig(budget=1.0, adapt=True, min_budget=0.25,
                       high_water=16, low_water=1)
    svc = _service(tunable=tc)
    xs, ys = _dataset(n=32)
    for i in range(24):
        svc.submit_rows(xs[i], np.full(K, ys[i]))
        svc.tick()
    svc.calibrate()
    scen = SCENARIOS["steady"]
    res = run_threaded(svc, make_scripts(scen, xs, ys, NC, K, seed=3),
                       scenario=scen, pace=0.0, seed=3)
    assert res.tick_budget is not None
    assert len(res.tick_budget) == res.ticks
    assert (res.tick_budget >= tc.min_budget).all()
    assert (res.tick_budget <= 1.0).all()
