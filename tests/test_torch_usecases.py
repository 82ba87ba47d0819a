"""The figure protocols of ``repro_torch.eval.usecases`` against the
reference's ``run()`` functions (``benchmarks/fig4_limited_data.py``,
``fig567_class_intro.py``, ``fig89_faults.py``), on the CPU.

Each protocol runs with its own defaults (the event at cycle 5, Fig 8/9's
20% stuck-at-0 fraction, Figs 5-7 on the whole offline set), with both
packages' ``run_schedule`` cut to 1 ordering and 6 cycles, so the event
lands and one cycle runs after it. The curves must be equal bit for bit,
the activity within rtol 2e-6 (ROADMAP queue 3), and the derived numbers
and names equal.
"""
import numpy as np
import pytest
import torch

ACT_RTOL = 2e-6
CUT = dict(n_orderings=1, n_cycles=6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several workers at
    once, and intra-op threads on top of them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cut_runs(monkeypatch):
    """Both packages' ``run_schedule`` at CUT."""
    from benchmarks import common
    from repro_torch.eval import usecases

    for mod in (common, usecases):
        full = mod.run_schedule
        monkeypatch.setattr(
            mod, "run_schedule",
            lambda schedule, _full=full, **kw: _full(schedule,
                                                     **dict(kw, **CUT)))


def _same_run(got, want):
    curve, act, _, O = got
    assert curve.shape == (1 + CUT["n_cycles"], 3) and O == want[3] == 1
    np.testing.assert_array_equal(curve.view(np.int32),
                                  np.asarray(want[0]).view(np.int32))
    np.testing.assert_allclose(act, want[1], rtol=ACT_RTOL, atol=0)


def test_limited_data_matches_reference(cut_runs):
    from benchmarks import fig4_limited_data
    from repro_torch.eval import usecases

    want_curve, want, _ = fig4_limited_data.run()
    curve, got, wall = usecases.limited_data(device="cpu")
    np.testing.assert_array_equal(curve.view(np.int32),
                                  np.asarray(want_curve).view(np.int32))
    assert got.keys() == want.keys() and wall > 0
    for k, v in want.items():
        if k == "mean_activity":
            np.testing.assert_allclose(got[k], v, rtol=ACT_RTOL)
        else:
            assert np.float32(got[k]) == np.float32(v), k


@pytest.mark.parametrize("protocol", ["class_introduction",
                                      "fault_mitigation"])
def test_event_protocol_matches_reference(cut_runs, protocol):
    from benchmarks import fig89_faults, fig567_class_intro
    from repro_torch.eval import usecases

    ref = {"class_introduction": fig567_class_intro,
           "fault_mitigation": fig89_faults}[protocol]
    want, want_event = ref.run()
    got, event = getattr(usecases, protocol)(device="cpu")
    assert event == want_event == 5
    assert list(got) == list(want)
    for name in want:
        _same_run(got[name], want[name])
