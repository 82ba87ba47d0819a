"""The correctness check fails what it must fail, at a size a CPU test
holds: the lower-precision control (the reference with bfloat16 uniform
draws in the system's place), and the system broken underneath a run
(a step that returns its state unchanged, half of the batch left out,
an answer altered where it is produced). The comparison between chips
has no fault to plant: every cell runs on one card."""
import pytest
import torch

from cpu_run import IRIS, MNIST, MNIST_CONFIG, cpu_run
from repro_torch.core import feedback as fb
from repro_torch.core import tm as ptm

CELLS = [("iris16-k8192-online", None, IRIS),
         ("mnist-demo-k16-online", MNIST_CONFIG, MNIST)]


def _unchanged(cfg, state, rt, x, y, key):
    new, votes, act = _REAL[0](cfg, state, rt, x, y, key)
    return state, votes, act


def _half(cfg, state, rt, x, y, key):
    new, votes, act = _REAL[0](cfg, state, rt, x, y, key)
    R = state.ta_state.shape[0]
    ta = torch.cat([new.ta_state[:R // 2], state.ta_state[R // 2:]])
    return ptm.TMState(ta), votes, act


def _altered(cfg, state, rt, xs):
    preds = _PRED[0](cfg, state, rt, xs)
    preds[..., 0] = (preds[..., 0] + 1) % cfg.max_classes
    return preds


_REAL = [fb.train_update_replicated]
_PRED = [ptm.predict_batch_replicated_]


@pytest.mark.parametrize("name,config,small", CELLS)
def test_sound_run_is_correct(name, config, small):
    _, line = cpu_run(name, config=config, **small)
    assert line["correct"] is True


@pytest.mark.parametrize("name,config,small", CELLS)
def test_bfloat16_control_is_not_correct(name, config, small):
    r, line = cpu_run(name, config=config, control="bf16", **small)
    assert line["correct"] is False
    assert sum(v for v, _ in r.checks.values()) > 0


@pytest.mark.parametrize("fault", [_unchanged, _half])
@pytest.mark.parametrize("name,config,small", CELLS)
def test_broken_step_is_not_correct(monkeypatch, fault, name, config, small):
    monkeypatch.setattr(fb, "train_update_replicated", fault)
    _, line = cpu_run(name, config=config, **small)
    assert line["correct"] is False


@pytest.mark.parametrize("name,config,small", CELLS)
def test_altered_answer_is_not_correct(monkeypatch, name, config, small):
    monkeypatch.setattr(ptm, "predict_batch_replicated_", _altered)
    _, line = cpu_run(name, config=config, **small)
    assert line["correct"] is False
