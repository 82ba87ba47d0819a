"""The port's entry points: ``repro_torch.eval.usecases`` and the nine
``examples/*_torch.py`` scripts, on the CPU.

* ``usecases.run_schedule`` against the reference's
  ``benchmarks.common.run_schedule``: the mean accuracy curve bit for bit
  and the mean activity within rtol 2e-6 (ROADMAP queue 3), on iris and
  on the MNIST-scale workload at side 4.
* The six TM examples at ``--device cpu`` print the reference example's
  lines, with the wall-clock and rate fields masked (and the quickstart's
  note on how the orderings ran, which names each package's engine). The
  two use-case examples that take no arguments run their reference
  protocol with the ordering count cut to 2 on both sides (each package's
  ``run_schedule`` wrapped, nothing else changed).
* The three LM examples run on the CPU with their checkpoints under
  ``tmp_path`` and report finite losses. Their weights come from torch's
  generator, so their numbers are not the reference's.
"""
import importlib.util
import math
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACT_RTOL = 2e-6
ORDERINGS = 2              # the argument-less use-case examples, both sides


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs several workers at
    once, and intra-op threads on top of them oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not called)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MASKS = (
    # quickstart: "<O> cross-validation orderings in <wall>s (<engine>)"
    (re.compile(r"(cross-validation orderings) in .*$"), r"\1 <wall>"),
    # tunable_serving's serve_ms column
    (re.compile(r"^(\s*\d+%\s+\d+\s+[\d.]+)\s+[\d.]+(\s)"), r"\1 <ms>\2"),
)


def _masked(text: str) -> list:
    lines = []
    for line in text.splitlines():
        for pat, sub in _MASKS:
            line = pat.sub(sub, line)
        lines.append(line)
    return lines


def _ref_lines(capsys, monkeypatch, name, argv):
    """What the reference example prints, run as its ``__main__`` does
    (``mnist_scale`` takes keywords; the others read ``sys.argv``)."""
    mod = _load(name)
    capsys.readouterr()
    if name == "mnist_scale":
        kw = dict(zip(argv[::2], argv[1::2]))
        mod.main(**{k.lstrip("-"): int(v) for k, v in kw.items()})
    else:
        monkeypatch.setattr(sys, "argv", [name] + argv)
        mod.main()
    return _masked(capsys.readouterr().out)


def _port_lines(capsys, name, argv):
    mod = _load(f"{name}_torch")
    capsys.readouterr()
    out = mod.main(argv + ["--device", "cpu"])
    return _masked(capsys.readouterr().out), out


@pytest.fixture
def cut_orderings(monkeypatch):
    """Both packages' ``run_schedule`` at ORDERINGS orderings."""
    from benchmarks import common
    from repro_torch.eval import usecases

    for mod in (common, usecases):
        full = mod.run_schedule
        monkeypatch.setattr(
            mod, "run_schedule",
            lambda schedule, _full=full, **kw: _full(
                schedule, **dict(kw, n_orderings=ORDERINGS)))


@pytest.mark.parametrize("dataset,side,orderings,cycles", [
    ("iris", None, 3, 2), ("mnist", 4, 2, 1)])
def test_run_schedule_matches_reference(dataset, side, orderings, cycles):
    from benchmarks import common
    from repro.core import manager as j_mgr
    from repro_torch.core import manager as t_mgr
    from repro_torch.eval import usecases

    kw = dict(n_orderings=orderings, n_cycles=cycles, dataset=dataset,
              side=side, seed=1)
    s_onl = usecases.system_params(dataset, side).s_online
    assert s_onl == common.system_params(dataset, side).s_online
    want = common.run_schedule(j_mgr.make_schedule(online_s=s_onl), **kw)
    got = usecases.run_schedule(t_mgr.make_schedule(online_s=s_onl),
                                device="cpu", **kw)
    assert got[0].shape == (1 + cycles, 3) and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  np.asarray(want[0]).view(np.int32))
    np.testing.assert_allclose(got[1], want[1], rtol=ACT_RTOL, atol=0)
    assert got[3] == want[3] == orderings
    assert usecases.curve_csv("x", got[0]) == common.curve_csv("x", want[0])


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--orderings", "2"]),
    ("serve_fleet", ["--replicas", "2", "--cycles", "24"]),
    ("mnist_scale", ["--side", "7", "--replicas", "1", "--epochs", "2",
                     "--cycles", "16"]),
    ("tunable_serving", ["--replicas", "1"]),
])
def test_tm_example_prints_the_reference_lines(capsys, monkeypatch, name,
                                               argv):
    want = _ref_lines(capsys, monkeypatch, name, argv)
    got, out = _port_lines(capsys, name, argv)
    assert got == want
    assert len(got) > 3 and isinstance(out, dict)


@pytest.mark.parametrize("name", ["class_introduction", "fault_mitigation"])
def test_usecase_example_prints_the_reference_lines(capsys, monkeypatch,
                                                    cut_orderings, name):
    want = _ref_lines(capsys, monkeypatch, name, [])
    got, out = _port_lines(capsys, name, [])
    assert got == want
    assert out["online"].shape == out["frozen"].shape == (17, 3)
    assert any("<--" in line for line in got)


def test_serve_lm_example_generates(capsys):
    out = _load("serve_lm_torch").main(["--device", "cpu", "--max-new", "6"])
    assert out.shape == (4, 6) and out.dtype == np.int32
    assert "first rows:" in capsys.readouterr().out


def test_train_lm_example_trains(tmp_path, capsys):
    report = _load("train_lm_torch").main(
        ["--small", "--steps", "4", "--ckpt", str(tmp_path / "ck"),
         "--device", "cpu"])
    assert report.steps_run == 4 and not report.fault_events
    assert len(report.losses) == 4
    assert all(math.isfinite(x) for x in report.losses)
    assert capsys.readouterr().out.splitlines()[-1].startswith("loss ")


def test_online_lm_adaptation_example_runs(tmp_path, capsys):
    out = _load("online_lm_adaptation_torch").main(
        ["--ckpt", str(tmp_path / "oa"), "--device", "cpu"])
    losses = [out["offline"]] + [loss for _, loss in out["history"]]
    assert len(out["history"]) == 1 + 24 // 4
    assert all(math.isfinite(x) for x in losses)
    assert out["rollbacks"] >= 0
    assert any((tmp_path / "oa").iterdir())
    assert capsys.readouterr().out.splitlines()[-1].startswith("final eval")
