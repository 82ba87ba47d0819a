"""The port's CUDA kernels on the card: each against its plain version.

These tests need a CUDA device, nvcc and the kernels' build; without a
card they skip with that reason. On the card, run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SHAPES = [(48, 32), (12, 33), (12, 513), (640, 1568)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_clause_count_kernels_equal_plain(cuda, shape):
    from repro_torch.kernels import clause_eval as ce

    cj, L = shape
    rng = np.random.default_rng(cj * L)
    inc = torch.from_numpy(rng.random((cj, L)) < 0.05).to(cuda)
    for B in (1, 33, 300):
        lits = torch.from_numpy(rng.random((B, L)) < 0.5).to(cuda)
        before = ce.clause_counts_batch.launches
        got = ce.clause_counts_batch(inc, lits)
        assert ce.clause_counts_batch.launches == before + 1
        want = ce.clause_counts_batch_plain(inc, lits)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = ce.clause_counts.launches
    got = ce.clause_counts(inc, lits[0])
    assert ce.clause_counts.launches == before + 1
    want = ce.clause_counts_plain(inc, lits[0])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,n_states", [(torch.int8, 63),
                                            (torch.int16, 5000)])
def test_feedback_kernel_equals_plain(cuda, shape, dtype, n_states):
    from repro_torch.kernels import feedback as fb

    cj, L = shape
    rng = np.random.default_rng(cj + L)
    ta = torch.from_numpy(rng.integers(1, 2 * n_states + 1, (cj, L))).to(
        dtype).to(cuda)
    lit = torch.from_numpy(rng.random(L) < 0.5).to(cuda)
    ctl = [torch.from_numpy(rng.random(cj) < 0.5).to(cuda) for _ in range(3)]
    u = torch.from_numpy(rng.random((cj, L), dtype=np.float32)).to(cuda)
    args = (ta, lit, *ctl, u, 0.75, 0.25)
    before = fb.feedback_plane.launches
    got = fb.feedback_plane(*args, n_states=n_states)
    assert fb.feedback_plane.launches == before + 1
    assert torch.equal(got, fb.feedback_plane_plain(*args, n_states=n_states))


def test_service_through_kernels_equals_plain(cuda):
    """The iris quickstart flow on the card: backend "cuda" (the kernels)
    against backend "ref" (plain PyTorch), bit for bit."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs, ys = iris.load()
    out = {}
    for backend in ("cuda", "ref"):
        cfg = dataclasses.replace(CONFIG.tm, backend=backend)
        svc = TMService(cfg, init_state(cfg, device=cuda),
                        ServiceConfig(chunk=8, buffer_capacity=32, s=1.0,
                                      T=15, policy=AdaptPolicy(16)),
                        eval_x=xs[100:], eval_y=ys[100:], device=cuda)
        counts = (ce.clause_counts.launches,
                  ce.clause_counts_batch.launches, fb.feedback_plane.launches)
        svc.offline_train(xs[:20], ys[:20], n_epochs=3)
        for i in range(32):
            svc.submit(0, xs[20 + i], int(ys[20 + i]))
            svc.tick()
        launched = [b - a for a, b in zip(counts, (
            ce.clause_counts.launches, ce.clause_counts_batch.launches,
            fb.feedback_plane.launches))]
        out[backend] = (svc.ss.tm.ta_state.cpu(), svc.rng_keys,
                        svc.serve(xs), svc.history, launched)
    a, r = out["cuda"], out["ref"]
    assert torch.equal(a[0], r[0])
    assert np.array_equal(a[1], r[1]) and np.array_equal(a[2], r[2])
    assert [np.asarray(x[1]).tolist() for x in a[3]] == \
        [np.asarray(x[1]).tolist() for x in r[3]]
    assert all(n > 0 for n in a[4]) and not any(r[4])
