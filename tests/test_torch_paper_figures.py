"""The port's twin of ``tests/test_paper_figures.py`` (paper §5, Figs 4-9).

For each figure and each seed the reference's small-scale set-up (6
orderings, 8 cycles, the event at cycle 3, a stuck-at-0 fraction of 0.75)
runs through the reference's ``CrossValRun.system`` and through the
port's ``repro_torch.eval.usecases.run_system`` on the CPU, from the same
numpy-built sets and seeded keys. The mean accuracy curves must be equal
bit for bit, so every band the reference's test asserts holds for the
port exactly as it holds (or fails) for the reference; no band is
asserted here anew. The mean activity curves are float32 means of non-0/1
values, which XLA sums in an order no fixed summation reproduces: they
are held to rtol 2e-6 (ROADMAP queue 3).

``-m slow`` runs the reference's full-scale pairs (24 orderings, 16
cycles, the events at cycle 5) the same way.
"""
import jax
import numpy as np
import pytest
import torch

import test_paper_figures as ref
from repro.core import manager as j_mgr
from repro.core import tm as j_tm
from repro.eval.crossval import CrossValRun as JCrossValRun
from repro.eval.crossval import replicate_state as j_replicate_state
from repro_torch.eval import usecases

ACT_RTOL = 2e-6
SMALL = dict(n_orderings=6, n_cycles=8)
SLOW = dict(n_orderings=24, n_cycles=16)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several workers at
    once, and intra-op threads on top of them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_curves(schedule, *, seed, n_orderings, n_cycles, offline_limit):
    """The reference test's ``_mean_curves`` set-up, with the activity."""
    sets, O = ref._sets(n_orderings, offline_limit)
    sys_cfg = j_mgr.SystemConfig(
        n_offline_epochs=ref.TM_SYS.n_offline_epochs,
        n_online_cycles=n_cycles)
    rt = j_tm.init_runtime(ref.CFG, s=ref.TM_SYS.s_offline, T=ref.TM_SYS.T)
    states = j_replicate_state(ref.CFG, O)
    keys = jax.random.split(jax.random.PRNGKey(seed), O)
    res = JCrossValRun(ref.CFG).system(sys_cfg, states, rt, sets, schedule,
                                       keys)
    return (np.asarray(res.accuracies).mean(axis=0),
            np.asarray(res.activity).mean(axis=0))


def _ref_schedule(fig, event):
    """The reference test's own schedule objects (their compiled programs
    are shared with it); the full-scale events make their own."""
    if event == 3 or fig in (4, 5):
        return getattr(ref, f"SCHED_FIG{fig}")
    if fig in (6, 7):
        return ref._sched_intro(event, online=fig == 7)
    return ref._sched_fault(event, online=fig == 9)


def _assert_twin(fig, *, seed, event, scale):
    """One figure's curve: the port's mean accuracy curve equal to the
    reference's bit for bit, the activity within ACT_RTOL."""
    limit = None if fig in (5, 6, 7) else 20
    want_acc, want_act = _ref_curves(_ref_schedule(fig, event), seed=seed,
                                     offline_limit=limit, **scale)
    schedule = usecases.figure_schedule(fig, event, ref.FAULT_FRACTION)
    res = usecases.run_system(schedule, seed=seed,
                              offline_limit=limit, device="cpu", **scale)
    acc, act = usecases.mean_curves(res)
    assert acc.shape == (1 + scale["n_cycles"], 3)
    assert acc.dtype == want_acc.dtype == np.float32
    np.testing.assert_array_equal(acc.view(np.int32),
                                  want_acc.view(np.int32),
                                  err_msg=f"fig {fig} seed {seed}")
    np.testing.assert_allclose(act, want_act, rtol=ACT_RTOL, atol=0,
                               err_msg=f"fig {fig} seed {seed}")
    return acc


@pytest.mark.parametrize("limit", [20, None])
def test_usecase_sets_are_the_reference_tests_sets(limit):
    """``usecases.build_sets`` gives the arrays the reference's test builds
    (so both sides start from the same numpy-built sets)."""
    got, O = usecases.build_sets(6, limit)
    want, O_ref = ref._sets(6, limit)
    assert O == O_ref == 6
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("fig", [3, 10])
def test_figure_schedule_knows_figs_4_to_9(fig):
    with pytest.raises(ValueError, match="Fig"):
        usecases.figure_schedule(fig)


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_fig4_limited_data_accuracy_ordering(seed):
    _assert_twin(4, seed=seed, event=3, scale=SMALL)


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_fig567_class_introduction_recovery(seed):
    """Figs 5, 6 and 7 equal the reference's curves. At seed 2 the
    reference's Fig-6 band fails (validation drops by 0.1434 at the
    introduction, the band asks for 0.15; ROADMAP queue 3), and the port
    gives that same curve."""
    for fig in (5, 6, 7):
        _assert_twin(fig, seed=seed, event=3, scale=SMALL)


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_fig89_fault_drop_then_recover(seed):
    for fig in (8, 9):
        _assert_twin(fig, seed=seed, event=3, scale=SMALL)


@pytest.mark.slow
def test_fig4_full_scale():
    _assert_twin(4, seed=0, event=5, scale=SLOW)


@pytest.mark.slow
def test_fig567_full_scale():
    for fig in (6, 7):
        _assert_twin(fig, seed=0, event=5, scale=SLOW)


@pytest.mark.slow
def test_fig89_full_scale():
    for fig in (8, 9):
        _assert_twin(fig, seed=0, event=5, scale=SLOW)
