"""The port's twin of ``tests/test_scale.py``: the wide datapath on the
generated booleanized digits, at 14 x 14 (f = 196) and the 7 x 7 word
tail (f = 49, not a multiple of 32) in tier-1, and 28 x 28 (f = 784)
under ``-m slow`` as in the reference:

* the sweep engine, "ref" against "cuda" per cell (on CPU tensors the
  kernel entries run their plain versions), and against the reference's
  sweep, bitwise;
* ``TMService`` end to end, submit -> tick -> serve with a §5.3.2
  rollback, per backend;
* whole tick trajectories, "ref" against "cuda" and against the
  reference's ``TMService``, bitwise;
* the packed service against the unpacked one per backend, and its
  rings' words (the tail word masked) against the reference's packing
  of the same rows, bitwise (int32 in the port, uint32 in the reference,
  the same bits).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tm_mnist as j_mnist_cfg
from repro.core import init_state as j_init_state
from repro.data import blocks as j_blocks
from repro.eval.crossval import CrossValRun as JCrossValRun
from repro.kernels import packing as j_packing
from repro.serve import AdaptPolicy as JAdaptPolicy
from repro.serve import ServiceConfig as JServiceConfig
from repro.serve import TMService as JTMService
from repro_torch.configs import tm_mnist
from repro_torch.core import init_state
from repro_torch.core.tm import TMState
from repro_torch.data import blocks, mnist
from repro_torch.eval.crossval import CrossValRun
from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

FAST_SIDE = 14
SLOW_SIDE = 28
TAIL_SIDE = 7
BACKENDS = ["ref", "cuda"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several workers at
    once, and intra-op threads on top of them oversubscribe the cores (the
    f = 196 sweep cell took 48-91 s beside other workers, 5.8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(side, backend="ref"):
    params = tm_mnist.config_for_side(side)
    return dataclasses.replace(params.tm, backend=backend), params


# ---------------------------------------------------------------------------
# sweep-cell parity at width
# ---------------------------------------------------------------------------


def _sweep_cell(side, backend, n_orderings=2, n_epochs=1):
    cfg, params = _cfg(side, backend)
    xs, ys = mnist.load(side=side)
    osets, _ = blocks.paper_sets(xs, ys, n_orderings)
    res = CrossValRun(cfg, device="cpu").sweep(
        osets.offline_x, osets.offline_y, osets.validation_x,
        osets.validation_y, (params.s_offline,), (params.T,),
        n_epochs=n_epochs, seed=0)
    return res.val_accuracy.numpy()


def _ref_sweep_cell(side, n_orderings=2, n_epochs=1):
    params = j_mnist_cfg.config_for_side(side)
    xs, ys = mnist.load(side=side)
    osets, _ = j_blocks.paper_sets(xs, ys, n_orderings)
    res = JCrossValRun(params.tm).sweep(
        jnp.asarray(osets.offline_x), jnp.asarray(osets.offline_y),
        jnp.asarray(osets.validation_x), jnp.asarray(osets.validation_y),
        (params.s_offline,), (params.T,), n_epochs=n_epochs, seed=0)
    return np.asarray(res.val_accuracy)


def _assert_sweep(side):
    a = _sweep_cell(side, "ref")
    b = _sweep_cell(side, "cuda")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 1, 2)
    np.testing.assert_array_equal(a, _ref_sweep_cell(side))


def test_sweep_cell_ref_cuda_bitwise_fast():
    """f = 196: one sweep cell per ordering."""
    _assert_sweep(FAST_SIDE)


@pytest.mark.slow
def test_sweep_cell_ref_cuda_bitwise_full_width():
    """f = 784: the full MNIST-width sweep cell."""
    _assert_sweep(SLOW_SIDE)


# ---------------------------------------------------------------------------
# TMService end to end at width: submit -> tick -> serve (+ §5.3.2 rollback)
# ---------------------------------------------------------------------------


def _sc(params, K, packed, policy_cls=AdaptPolicy, sc_cls=ServiceConfig):
    return sc_cls(replicas=K, buffer_capacity=32, chunk=8,
                  s=params.s_online, T=params.T, seed=[3, 4][:K],
                  packed=packed,
                  policy=policy_cls(analyze_every=8, rollback_threshold=0.1))


def _service(side, backend, K=2, packed=False):
    cfg, params = _cfg(side, backend)
    tr_x, tr_y, te_x, te_y = mnist.splits(60, 40, seed=5, side=side)
    svc = TMService(cfg, init_state(cfg, device="cpu"),
                    _sc(params, K, packed), eval_x=te_x, eval_y=te_y,
                    device="cpu")
    return svc, (tr_x, tr_y, te_x, te_y)


def _drive(svc, tr_x, tr_y, n=16):
    """Identical labelled traffic through submit -> tick; the reports."""
    reports = []
    for i in range(n):
        svc.submit_rows(tr_x[i % len(tr_x)], int(tr_y[i % len(tr_y)]))
        if (i + 1) % svc.chunk == 0:
            reports.append(svc.tick())
    return reports


def _e2e_rollback(side, backend):
    svc, (tr_x, tr_y, te_x, te_y) = _service(side, backend)
    base = svc.offline_train(tr_x, tr_y, n_epochs=4)
    assert base.shape == (2,)
    assert float(base.min()) > 0.3          # learnt something at width

    # poison member 0's bank; member 1 keeps serving untouched (§5.3.2
    # isolation), and the next due analysis rolls member 0 back
    poisoned = svc.ss.tm.ta_state.clone()
    poisoned[0] = init_state(svc.cfg, device="cpu").ta_state
    svc.ss = svc.ss._replace(tm=TMState(ta_state=poisoned))

    reports = _drive(svc, tr_x, tr_y, n=16)
    fired = [r for r in reports if r.accuracy is not None]
    assert fired, "no analysis became due"
    assert svc.rollbacks.tolist() == [1, 0]
    assert any(r.rolled_back.tolist() == [True, False] for r in fired)

    preds = svc.serve(te_x)
    assert preds.shape == (2, len(te_x))
    acc_served = (np.asarray(preds[1]) == np.asarray(te_y)).mean()
    assert float(acc_served) >= float(base[1]) - 0.15
    # the rolled-back member is back near its known-good accuracy
    assert float(svc.analyze()[0]) >= float(base[0]) - 0.1


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_end_to_end_rollback_fast(backend):
    """f = 196 submit -> tick -> serve with a §5.3.2 rollback."""
    _e2e_rollback(FAST_SIDE, backend)


@pytest.mark.slow
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_end_to_end_rollback_full_width(backend):
    _e2e_rollback(SLOW_SIDE, backend)


# ---------------------------------------------------------------------------
# tick trajectories: across backends and against the reference's service
# ---------------------------------------------------------------------------


def _record(svc, reports, te_x):
    """What a trajectory left: TA banks, steps, reports, served
    predictions, accuracies, ring words."""
    return {"ta": np.asarray(svc.ss.tm.ta_state),
            "steps": np.asarray(svc.steps),
            "reports": [(np.asarray(r.trained), None if r.accuracy is None
                         else np.asarray(r.accuracy)) for r in reports],
            "serve": np.asarray(svc.serve(te_x)),
            "analyze": np.asarray(svc.analyze()),
            "ring": np.asarray(svc.ss.buf.data_x)}


@functools.lru_cache(maxsize=None)
def _trajectory(side, backend, packed=False):
    svc, (tr_x, tr_y, te_x, _) = _service(side, backend, packed=packed)
    svc.offline_train(tr_x[:20], tr_y[:20], n_epochs=2)
    reports = _drive(svc, tr_x, tr_y, n=16)
    rec = _record(svc, reports, te_x)
    rec["dtype"] = svc.ss.buf.data_x.dtype
    return rec


@functools.lru_cache(maxsize=None)
def _ref_trajectory(side):
    params = j_mnist_cfg.config_for_side(side)
    tr_x, tr_y, te_x, te_y = mnist.splits(60, 40, seed=5, side=side)
    svc = JTMService(params.tm, j_init_state(params.tm),
                     _sc(params, 2, False, JAdaptPolicy, JServiceConfig),
                     eval_x=te_x, eval_y=te_y)
    svc.offline_train(tr_x[:20], tr_y[:20], n_epochs=2)
    reports = _drive(svc, tr_x, tr_y, n=16)
    return _record(svc, reports, te_x)


def _assert_same(a, b, what):
    np.testing.assert_array_equal(a["ta"], b["ta"], err_msg=what)
    np.testing.assert_array_equal(a["steps"], b["steps"], err_msg=what)
    assert len(a["reports"]) == len(b["reports"]), what
    for (ta, aa), (tb, ab) in zip(a["reports"], b["reports"]):
        np.testing.assert_array_equal(ta, tb, err_msg=what)
        assert (aa is None) == (ab is None), what
        if aa is not None:
            np.testing.assert_array_equal(aa, ab, err_msg=what)
    np.testing.assert_array_equal(a["serve"], b["serve"], err_msg=what)
    np.testing.assert_array_equal(a["analyze"], b["analyze"], err_msg=what)


def _assert_tick_parity(side):
    ref = _trajectory(side, "ref")
    _assert_same(ref, _trajectory(side, "cuda"), "ref vs cuda")
    _assert_same(ref, _ref_trajectory(side), "port vs reference")


def test_service_tick_ref_cuda_bitwise_fast():
    """f = 196: whole tick trajectories bitwise across backends and
    against the reference's service."""
    _assert_tick_parity(FAST_SIDE)


@pytest.mark.slow
def test_service_tick_ref_cuda_bitwise_full_width():
    _assert_tick_parity(SLOW_SIDE)


# ---------------------------------------------------------------------------
# the packed datapath: whole service trajectories, packed vs unpacked
# ---------------------------------------------------------------------------


def _assert_packed_parity(side, backend):
    """``ServiceConfig(packed=True)`` == ``packed=False`` bit for bit:
    trained TA banks, tick reports, served predictions, analysis."""
    base = _trajectory(side, backend)
    pk = _trajectory(side, backend, packed=True)
    assert pk["dtype"] == torch.int32 and base["dtype"] == torch.bool
    assert pk["ring"].shape[-1] < base["ring"].shape[-1]
    _assert_same(base, pk, f"packed vs unpacked, {backend}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_packed_parity_word_tail(backend):
    """f = 49 (side 7, not a multiple of 32): the tail word's masking
    through the whole service trajectory; the 16 rows the rings took are
    the reference's packing of them, bit for bit."""
    _assert_packed_parity(TAIL_SIDE, backend)
    ring = _trajectory(TAIL_SIDE, backend, packed=True)["ring"]
    tr_x = mnist.splits(60, 40, seed=5, side=TAIL_SIDE)[0]
    K, cap, W = ring.shape
    want = np.zeros((K, cap, W), np.uint32)
    want[:, :16] = np.asarray(j_packing.pack_bits(jnp.asarray(tr_x[:16])))
    assert W == 2 and (want[:, :16, 1] >> 17).max() == 0  # 49 = 32 + 17
    np.testing.assert_array_equal(ring.view(np.uint32), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_packed_parity_fast(backend):
    """f = 196: packed == unpacked service trajectories."""
    _assert_packed_parity(FAST_SIDE, backend)


@pytest.mark.slow
@pytest.mark.parametrize("backend", BACKENDS)
def test_service_packed_parity_full_width(backend):
    _assert_packed_parity(SLOW_SIDE, backend)
