"""The port's Fig-3 system manager against the reference's.

``run_system`` (one machine, through K1/K2/K8's plain versions on the CPU)
and ``run_orderings`` (all orderings at once, through the replica-first
engine and K3/K4/K9's plain versions) against ``repro.core.manager`` for
tests/test_manager.py's three use cases on iris (O = 3 orderings,
SystemConfig(2, 3)): online learning (§5.1), class introduction (§5.2)
and fault mitigation with online learning on and off (§5.3); plus one
MNIST-scale run at ``config_for_side(7)``.

Accuracy curves and final TA banks must agree bit for bit. The activity
curves are float32 means of non-0/1 per-step activities; XLA reduces them
in an order that no fixed summation reproduces, so they are held to
rtol = 2e-6 (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tm_mnist as j_mnist_cfg
from repro.core import faults as j_faults
from repro.core import manager as j_mgr
from repro.core import tm as j_tm
from repro.data import blocks as j_blocks
from repro_torch import convert
from repro_torch.configs import tm_mnist as t_mnist_cfg
from repro_torch.core import faults as t_faults
from repro_torch.core import manager as t_mgr
from repro_torch.core import tm as t_tm
from repro_torch.eval import crossval as t_cv

FIELDS = dict(n_features=16, max_classes=3, max_clauses=16, n_states=50)
J_CFG = j_tm.TMConfig(**FIELDS)
T_CFG = t_tm.TMConfig(**FIELDS)
O = 3
ACT_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread. The suite runs several pytest workers
    at once; torch's intra-op threads on top of them oversubscribe the
    cores, and an MNIST-width flow then ran 20-40x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sets(osets, offline_limit):
    Oo, n_off = osets.offline_y.shape
    train_valid = np.ones((Oo, n_off), dtype=bool)
    if offline_limit is not None:
        train_valid[:, offline_limit:] = False
    return j_mgr.Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((Oo, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=train_valid)


def _schedules(case, j_cfg, t_cfg):
    """(reference schedule, port schedule, offline_limit) for a use case."""
    if case == "online":
        kw = dict(online_s=1.0)
        return (j_mgr.make_schedule(**kw), t_mgr.make_schedule(**kw), 20)
    if case == "class_intro":
        kw = dict(online_s=1.0, filtered_class=0, introduce_at_cycle=1)
        return (j_mgr.make_schedule(**kw), t_mgr.make_schedule(**kw), None)
    enabled = case == "faults_online"
    j_masks = j_faults.even_spread_stuck_at(j_cfg, 0.2, 0)
    t_masks = t_faults.even_spread_stuck_at(t_cfg, 0.2, 0)
    assert all(np.array_equal(a, b) for a, b in zip(j_masks, t_masks))
    return (j_mgr.make_schedule(
                online_s=1.0, online_enabled=enabled, inject_at_cycle=1,
                fault_masks=tuple(jnp.asarray(m) for m in j_masks)),
            t_mgr.make_schedule(online_s=1.0, online_enabled=enabled,
                                inject_at_cycle=1, fault_masks=t_masks),
            20)


@pytest.fixture(scope="module")
def iris_osets():
    osets, _ = j_blocks.iris_paper_sets(n_orderings=O)
    return osets


def _check(j_out, t_out):
    (j_st, j_acc, j_act), (t_st, t_acc, t_act) = j_out, t_out
    assert np.array_equal(_bits(j_acc), _bits(t_acc.cpu().numpy()))
    assert np.array_equal(np.asarray(j_st.ta_state),
                          t_st.ta_state.cpu().numpy())
    assert t_act.shape == np.shape(j_act)
    np.testing.assert_allclose(t_act.cpu().numpy(), np.asarray(j_act),
                               rtol=ACT_RTOL, atol=0)


CASES = ["online", "class_intro", "faults_online", "faults_frozen"]


@pytest.mark.parametrize("case", CASES)
def test_run_system_matches_reference(iris_osets, case):
    j_sched, t_sched, limit = _schedules(case, J_CFG, T_CFG)
    sets = _sets(iris_osets, limit)
    sys_j, sys_t = j_mgr.SystemConfig(2, 3), t_mgr.SystemConfig(2, 3)
    o = 1
    one = j_mgr.Sets(*(None if v is None else v[o] for v in sets))
    key = jax.random.PRNGKey(o)
    j_out = j_mgr.run_system(
        J_CFG, sys_j, j_tm.init_state(J_CFG),
        j_tm.init_runtime(J_CFG, s=1.375, T=15),
        jax.tree.map(jnp.asarray, one), j_sched, key)
    t_out = t_mgr.run_system(
        T_CFG, sys_t, t_tm.init_state(T_CFG, device="cpu"),
        t_tm.init_runtime(T_CFG, s=1.375, T=15, device="cpu"),
        convert.sets_from_numpy(one, "cpu"), t_sched,
        convert.key_from_numpy(key, "cpu"))
    assert t_out[1].shape == (4, 3) and t_out[2].shape == (3,)
    _check(j_out, t_out)
    if case == "faults_frozen":
        # Frozen after the fault: the curve is flat from the injection on.
        acc = t_out[1].numpy()
        assert np.all(acc[2:, 1] == acc[2, 1])
        assert np.all(t_out[2].numpy() == 0.0)


@pytest.mark.parametrize("case", CASES)
def test_run_orderings_matches_reference(iris_osets, case):
    j_sched, t_sched, limit = _schedules(case, J_CFG, T_CFG)
    sets = _sets(iris_osets, limit)
    keys = jax.random.split(jax.random.PRNGKey(9), O)
    j_out = j_mgr.run_orderings(
        J_CFG, j_mgr.SystemConfig(2, 3),
        jax.vmap(lambda _: j_tm.init_state(J_CFG))(jnp.arange(O)),
        j_tm.init_runtime(J_CFG, s=1.375, T=15),
        jax.tree.map(jnp.asarray, sets), j_sched, keys)
    t_out = t_mgr.run_orderings(
        T_CFG, t_mgr.SystemConfig(2, 3), t_cv.replicate_state(T_CFG, O, "cpu"),
        t_tm.init_runtime(T_CFG, s=1.375, T=15, device="cpu"),
        convert.sets_from_numpy(sets, "cpu"), t_sched,
        convert.key_from_numpy(keys, "cpu"))
    assert t_out[1].shape == (O, 4, 3) and t_out[2].shape == (O, 3)
    _check(j_out, t_out)


def test_run_orderings_mnist_matches_reference():
    """The MNIST-scale machine (f = 49, 10 classes x 64 clauses, int8 bank)
    through the same engine."""
    j_params = j_mnist_cfg.config_for_side(7)
    t_params = t_mnist_cfg.config_for_side(7)
    assert all(getattr(j_params.tm, f) == getattr(t_params.tm, f)
               for f in ("n_features", "max_classes", "max_clauses",
                         "n_states", "s_policy", "boost_true_positive"))
    osets, _ = j_blocks.mnist_paper_sets(n_orderings=2, side=7)
    sets = _sets(osets, 20)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    sched_kw = dict(online_s=t_params.s_online)
    j_out = j_mgr.run_orderings(
        j_params.tm, j_mgr.SystemConfig(1, 2),
        jax.vmap(lambda _: j_tm.init_state(j_params.tm))(jnp.arange(2)),
        j_tm.init_runtime(j_params.tm, s=j_params.s_offline, T=j_params.T),
        jax.tree.map(jnp.asarray, sets), j_mgr.make_schedule(**sched_kw),
        keys)
    t_out = t_mgr.run_orderings(
        t_params.tm, t_mgr.SystemConfig(1, 2),
        t_cv.replicate_state(t_params.tm, 2, "cpu"),
        t_tm.init_runtime(t_params.tm, s=t_params.s_offline, T=t_params.T,
                          device="cpu"),
        convert.sets_from_numpy(sets, "cpu"),
        t_mgr.make_schedule(**sched_kw), convert.key_from_numpy(keys, "cpu"))
    assert t_out[0].ta_state.dtype.itemsize == 1
    _check(j_out, t_out)


def test_schedule_is_broadcast_safe(iris_osets):
    """One schedule serves single-machine and [O]-stacked sets alike."""
    _, sched, _ = _schedules("class_intro", J_CFG, T_CFG)
    sets = convert.sets_from_numpy(_sets(iris_osets, None), "cpu")
    rt = t_tm.init_runtime(T_CFG, s=1.375, T=15, device="cpu")
    stacked = sched(0, rt, sets)
    single = sched(0, rt, t_mgr.Sets(*(None if v is None else v[2]
                                       for v in sets)))
    assert np.array_equal(stacked.sets.validation_valid[2].numpy(),
                          single.sets.validation_valid.numpy())
    assert stacked.rt.class_mask.tolist() == [False, True, True]
    assert float(stacked.rt.s) == 1.0
    assert float(sched(-1, rt, sets).rt.s) == 1.375
    assert sched(1, rt, sets).rt.class_mask.tolist() == [True, True, True]


def test_faults_helpers():
    rt = t_tm.init_runtime(T_CFG, device="cpu")
    hit = t_faults.stuck_at_runtime(T_CFG, rt, 0.25, 1, seed=5)
    j_and, j_or = j_faults.random_stuck_at(J_CFG, 0.25, 1, 5)
    assert np.array_equal(hit.ta_and_mask.numpy(), j_and)
    assert np.array_equal(hit.ta_or_mask.numpy(), j_or)
    even = t_faults.stuck_at_runtime(T_CFG, rt, 0.1, 0, offset=3)
    j_and, j_or = j_faults.even_spread_stuck_at(J_CFG, 0.1, 0, offset=3)
    assert np.array_equal(even.ta_and_mask.numpy(), j_and)
    cleared = t_faults.clear(T_CFG, even)
    assert bool(cleared.ta_and_mask.all()) and not bool(
        cleared.ta_or_mask.any())
    # the packed masks (the packed datapath) equal the reference's words
    j_rt = j_faults.inject(j_tm.init_runtime(J_CFG), j_and, j_or)
    for got, want in zip(t_faults.packed_masks(T_CFG, even),
                         j_faults.packed_masks(J_CFG, j_rt)):
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
