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

# (CJ, L, offset). K1/K3 and K8/K9 take a vector path for L % 16 == 0 with
# 16-byte-aligned operands (L = 16, 32, 1568) and a scalar path for the
# rest: the other widths, and operands that are views ``offset`` elements
# into a larger tensor (:func:`_at`; 33 is row 1 of a [2, 33] tensor).
SHAPES = ([(48, 32, 0), (12, 33, 0), (12, 513, 0), (640, 1568, 0)]
          + [(12, L, 0) for L in (1, 15, 16, 17, 98)]
          + [(48, 32, 1), (12, 33, 33), (640, 1568, 3)])
# Replica-first shapes (R, D, CJ, L, offset): grids over shared streams
# (D < R), the same boundary widths and views.
REP_SHAPES = ([(6, 3, 48, 32, 0), (3, 1, 12, 33, 0), (4, 2, 12, 513, 0),
               (8, 8, 640, 1568, 0), (16, 4, 640, 1568, 0)]
              + [(4, 2, 12, L, 0) for L in (1, 15, 16, 17, 98)]
              + [(6, 3, 48, 32, 1), (3, 1, 12, 33, 33),
                 (16, 4, 640, 1568, 3)])


def _at(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t`` as a contiguous view ``offset`` elements into a larger
    tensor on the same device."""
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
def test_clause_count_kernels_equal_plain(cuda, shape):
    from repro_torch.kernels import clause_eval as ce

    cj, L, off = shape
    rng = np.random.default_rng(cj * L)
    inc = _at(torch.from_numpy(rng.random((cj, L)) < 0.05).to(cuda), off)
    for B in (1, 33, 300):
        lits = _at(torch.from_numpy(rng.random((B, L)) < 0.5).to(cuda), off)
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

    cj, L, off = shape
    rng = np.random.default_rng(cj + L)
    ta = torch.from_numpy(rng.integers(1, 2 * n_states + 1, (cj, L))).to(
        dtype).to(cuda)
    lit = torch.from_numpy(rng.random(L) < 0.5).to(cuda)
    ctl = [torch.from_numpy(rng.random(cj) < 0.5).to(cuda) for _ in range(3)]
    u = torch.from_numpy(rng.random((cj, L), dtype=np.float32)).to(cuda)
    args = (*(_at(t, off) for t in (ta, lit, *ctl, u)), 0.75, 0.25)
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


@pytest.mark.parametrize("shape", REP_SHAPES)
def test_replicated_count_kernels_equal_plain(cuda, shape):
    from repro_torch.kernels import clause_eval as ce

    R, D, cj, L, off = shape
    rng = np.random.default_rng([R, D, cj, L])
    inc = _at(torch.from_numpy(rng.random((R, cj, L)) < 0.05).to(cuda), off)
    for B in (1, 7, 150):
        lits = _at(torch.from_numpy(rng.random((D, B, L)) < 0.5).to(cuda),
                   off)
        before = ce.clause_counts_batch_replicated.launches
        got = ce.clause_counts_batch_replicated(inc, lits)
        assert ce.clause_counts_batch_replicated.launches == before + 1
        want = ce.clause_counts_batch_replicated_plain(inc, lits)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = ce.clause_counts_replicated.launches
    got = ce.clause_counts_replicated(inc, lits[:, 0])
    assert ce.clause_counts_replicated.launches == before + 1
    want = ce.clause_counts_replicated_plain(inc, lits[:, 0])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("dtype,n_states", [(torch.int8, 63),
                                            (torch.int16, 5000)])
def test_replicated_feedback_kernel_equals_plain(cuda, shape, dtype,
                                                 n_states):
    from repro_torch.kernels import feedback as fb

    R, D, cj, L, off = shape
    rng = np.random.default_rng([R, D, cj, L, n_states])
    ta = torch.from_numpy(rng.integers(1, 2 * n_states + 1, (R, cj, L))).to(
        dtype).to(cuda)
    lit = torch.from_numpy(rng.random((D, L)) < 0.5).to(cuda)
    ctl = [torch.from_numpy(rng.random((R, cj)) < 0.5).to(cuda)
           for _ in range(3)]
    u = torch.from_numpy(rng.random((D, cj, L), dtype=np.float32)).to(cuda)
    ps, pe = (torch.from_numpy(rng.random(R, dtype=np.float32)).to(cuda)
              for _ in range(2))
    args = tuple(_at(t, off) for t in (ta, lit, *ctl, u, ps, pe))
    before = fb.feedback_plane_replicated.launches
    got = fb.feedback_plane_replicated(*args, n_states=n_states)
    assert fb.feedback_plane_replicated.launches == before + 1
    assert torch.equal(got, fb.feedback_plane_replicated_plain(
        *args, n_states=n_states))


def test_sweep_through_kernels_equals_plain(cuda):
    """A small iris sweep on the card: backend "cuda" (K3/K4/K9) against
    backend "ref", bit for bit."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.data import blocks
    from repro_torch.eval.crossval import CrossValRun
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb

    osets, _ = blocks.iris_paper_sets(n_orderings=4)
    out = {}
    for backend in ("cuda", "ref"):
        cfg = dataclasses.replace(CONFIG.tm, backend=backend)
        before = (ce.clause_counts_replicated.launches,
                  ce.clause_counts_batch_replicated.launches,
                  fb.feedback_plane_replicated.launches)
        res = CrossValRun(cfg, device=cuda).sweep(
            osets.offline_x, osets.offline_y, osets.validation_x,
            osets.validation_y, (1.375, 3.0), (5, 15), n_epochs=2)
        launched = [b - a for a, b in zip(before, (
            ce.clause_counts_replicated.launches,
            ce.clause_counts_batch_replicated.launches,
            fb.feedback_plane_replicated.launches))]
        out[backend] = (res.val_accuracy.cpu(), launched)
    assert torch.equal(out["cuda"][0], out["ref"][0])
    assert out["cuda"][1] == [60, 1, 60] and out["ref"][1] == [0, 0, 0]


def test_run_system_through_kernels_equals_plain(cuda):
    """One machine's Fig-3 flow (K1/K2/K8) and the same flow over four
    orderings (K3/K4/K9) on the card, with a fault injected: backend
    "cuda" against backend "ref", bit for bit."""
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import faults, manager
    from repro_torch.core.tm import init_runtime, init_state
    from repro_torch.data import blocks
    from repro_torch.eval.crossval import replicate_state

    osets, _ = blocks.iris_paper_sets(n_orderings=4)
    n_off = osets.offline_y.shape[1]
    sets = convert.sets_from_numpy(manager.Sets(
        osets.offline_x, osets.offline_y, np.ones((4, n_off), bool),
        osets.validation_x, osets.validation_y,
        np.ones(osets.validation_y.shape, bool), osets.online_x,
        osets.online_y, np.ones(osets.online_y.shape, bool)), cuda)
    one = manager.Sets(*(v[0] for v in sets[:9]))
    out = {}
    for backend in ("cuda", "ref"):
        cfg = dataclasses.replace(CONFIG.tm, backend=backend)
        schedule = manager.make_schedule(
            online_s=1.0, inject_at_cycle=1,
            fault_masks=faults.even_spread_stuck_at(cfg, 0.2, 0))
        rt = init_runtime(cfg, s=1.375, T=15, device=cuda)
        sys_cfg = manager.SystemConfig(2, 2)
        single = manager.run_system(cfg, sys_cfg, init_state(cfg, device=cuda),
                                    rt, one, schedule,
                                    rnd.PRNGKey(3, cuda))
        many = manager.run_orderings(cfg, sys_cfg,
                                     replicate_state(cfg, 4, cuda), rt, sets,
                                     schedule, rnd.split(rnd.PRNGKey(3, cuda),
                                                         4))
        out[backend] = [t.cpu() for t in (single[0].ta_state, *single[1:],
                                          many[0].ta_state, *many[1:])]
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"], out["ref"]))


# Packed shapes (f, CJ): W = 2 * ceil(f / 32) words per literal row.
PACKED_SHAPES = [(16, 12), (33, 48), (49, 48), (784, 640)]
# (R, D) grids for K6 at the MNIST width.
PACKED_RD = [(1, 1), (4, 2), (3, 3), (16, 16), (16, 1)]


def _packed_case(rng, f, cj, lead_inc, lead_lit, B, cuda):
    from repro_torch.kernels import packing

    inc = rng.random(lead_inc + (cj, 2 * f)) < 0.05
    inc[..., 0, :] = False                    # an empty clause row
    inc[..., 1, :] = True                     # an all-include row
    x = rng.random(lead_lit + (B, f)) < 0.5
    lits = np.concatenate([x, ~x], -1)
    inc_t, x_t = torch.from_numpy(inc).to(cuda), torch.from_numpy(x).to(cuda)
    return (packing.pack_include(inc_t, f), packing.pack_literals(x_t),
            inc_t, torch.from_numpy(lits).to(cuda))


@pytest.mark.parametrize("f,cj", PACKED_SHAPES)
def test_packed_count_kernel_equals_plain_and_unpacked(cuda, f, cj):
    """K5 against its plain version and against K2 on the unpacked
    operands."""
    from repro_torch.kernels import clause_eval as ce

    rng = np.random.default_rng([f, cj])
    for B in (1, 7, 150, 1024):
        inc_w, lit_w, inc, lits = _packed_case(rng, f, cj, (), (), B, cuda)
        before = ce.clause_counts_batch_packed.launches
        got = ce.clause_counts_batch_packed(inc_w, lit_w)
        assert ce.clause_counts_batch_packed.launches == before + 1
        assert torch.equal(got, ce.clause_counts_batch_packed_plain(inc_w,
                                                                    lit_w))
        assert torch.equal(got, ce.clause_counts_batch(inc, lits)[0])


@pytest.mark.parametrize("RD", PACKED_RD)
def test_packed_replicated_count_kernel_equals_plain_and_unpacked(cuda, RD):
    """K6 at 640 x 50 words against its plain version and K4."""
    from repro_torch.kernels import clause_eval as ce

    R, D = RD
    rng = np.random.default_rng([R, D])
    for B in (1, 150):
        inc_w, lit_w, inc, lits = _packed_case(rng, 784, 640, (R,), (D,), B,
                                               cuda)
        before = ce.clause_counts_batch_replicated_packed.launches
        got = ce.clause_counts_batch_replicated_packed(inc_w, lit_w)
        assert ce.clause_counts_batch_replicated_packed.launches == before + 1
        assert torch.equal(got, ce.clause_counts_batch_replicated_packed_plain(
            inc_w, lit_w))
        assert torch.equal(got, ce.clause_counts_batch_replicated(inc,
                                                                  lits)[0])


def test_packed_fleet_through_kernels_equals_plain(cuda):
    """A packed K = 3 fleet with per-replica ports on the card: backend
    "cuda" (K3/K9 training, K6 monitoring/serving/analysis) against
    backend "ref", bit for bit."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs, ys = iris.load()
    out = {}
    for backend in ("cuda", "ref"):
        cfg = dataclasses.replace(CONFIG.tm, backend=backend)
        svc = TMService(cfg, init_state(cfg, device=cuda), ServiceConfig(
            replicas=3, packed=True, chunk=4, buffer_capacity=16,
            s=[1.375, 3.0, 5.0], T=[5, 15, 10], seed=[1, 2, 3],
            policy=AdaptPolicy(8)), eval_x=xs[100:], eval_y=ys[100:],
            device=cuda)
        before = ce.clause_counts_batch_replicated_packed.launches
        svc.offline_train(xs[:30], ys[:30], n_epochs=2)
        chunks = []
        for i in range(30, 70):
            svc.submit_rows(xs[i], int(ys[i]))
            if i % 4 == 3:
                svc.tick(on_chunk=chunks.append)
        served = svc.serve(xs[:50])
        out[backend] = (svc.ss.tm.ta_state.cpu(), svc.rng_keys, served,
                        [a.cpu() for c in chunks for a in c],
                        [h[1].tolist() for h in svc.history],
                        ce.clause_counts_batch_replicated_packed.launches
                        - before)
    a, r = out["cuda"], out["ref"]
    assert torch.equal(a[0], r[0]) and np.array_equal(a[1], r[1])
    assert np.array_equal(a[2], r[2]) and a[4] == r[4]
    assert all(torch.equal(x, y) for x, y in zip(a[3], r[3]))
    assert a[5] > 0 and r[5] == 0


def test_sharded_fleet_on_card_equals_unsharded(cuda):
    """A packed K = 8 fleet with per-replica ports sharded in four slabs on
    the one card (``Mesh(["cuda:0"] * 4, ("data",))``) against the same
    fleet without a mesh: banks, rings, keys, chunk aux, history and
    serves bit for bit, and the replicated kernels launched per slab."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs, ys = iris.load()
    counters = (ce.clause_counts_replicated, fb.feedback_plane_replicated,
                ce.clause_counts_batch_replicated_packed)
    out = {}
    for mesh in (None, Mesh([cuda] * 4, ("data",))):
        svc = TMService(CONFIG.tm, init_state(CONFIG.tm, device=cuda),
                        ServiceConfig(
                            replicas=8, packed=True, chunk=4,
                            buffer_capacity=16, mesh=mesh,
                            s=[1.375, 3.0, 5.0, 2.0, 3.9, 1.375, 2.5, 4.0],
                            T=[5, 15, 10, 12, 20, 8, 15, 11],
                            seed=list(range(8)), policy=AdaptPolicy(8)),
                        eval_x=xs[100:], eval_y=ys[100:], device=cuda)
        before = [c.launches for c in counters]
        svc.offline_train(xs[:30], ys[:30], n_epochs=2)
        chunks = []
        for i in range(30, 70):
            svc.submit_rows(xs[i - 30:i - 22], ys[i - 30:i - 22])
            if i % 4 == 3:
                svc.tick(max_points=np.arange(8) % 5 + 1,
                         on_chunk=chunks.append)
        ss = svc.ss
        out[mesh is None] = (
            [ss.tm.ta_state.cpu(), *(a.cpu() for a in ss.buf),
             ss.step.cpu()], svc.rng_keys, svc.serve(xs[:50]),
            [a.cpu() for c in chunks for a in c],
            [h[1].tolist() for h in svc.history],
            [c.launches - b for c, b in zip(counters, before)])
    a, b = out[True], out[False]
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(a[3], b[3]))
    assert a[4] == b[4]
    # K6 (monitoring, analysis, serving): one launch a slab where the
    # unsharded plane launches once; K3/K9 a step of each slab, which
    # loops to its own largest budget
    (k3, k9, k6), (s3, s9, s6) = a[5], b[5]
    assert k3 > 0 and k9 > 0 and s6 == 4 * k6 > 0
    assert k3 < s3 <= 4 * k3 and k9 < s9 <= 4 * k9


# The pruned entries (K7): f, (R, D), selections of every kind.
PRUNED_F = (16, 33, 784)
PRUNED_RD = ((1, 1), (4, 2), (16, 1))


def _pruned_sels(rng, R, C, J, cuda):
    """Per-replica selections [R, C, M]: a permutation prefix at M = 1,
    J/2 and J, and arbitrary ids with repeats at M = J/2."""
    out = []
    for M in (1, J // 2, J):
        out.append(np.stack([np.stack([rng.permutation(J)[:M]
                                       for _ in range(C)])
                             for _ in range(R)]))
    rep = rng.integers(0, J, (R, C, J // 2))
    rep[..., -1] = rep[..., 0]
    out.append(rep)
    return [torch.from_numpy(s.astype(np.int32)).to(cuda) for s in out]


@pytest.mark.parametrize("f", PRUNED_F)
@pytest.mark.parametrize("RD", PRUNED_RD)
def test_pruned_count_kernels_equal_plain_and_gathered(cuda, f, RD):
    """K7 on bytes and on words against their plain versions, against
    the gather + K4/K6 kernels, and packed against unpacked."""
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import ref

    R, D = RD
    C, J = 10, 16
    rng = np.random.default_rng([f, R, D])
    inc_w, lit_w, inc, lits = _packed_case(rng, f, C * J, (R,), (D,), 37,
                                           cuda)
    inc4, inc4_w = inc.reshape(R, C, J, -1), inc_w.reshape(R, C, J, -1)
    for sel in _pruned_sels(rng, R, C, J, cuda):
        M = sel.shape[-1]
        before = (ce.clause_counts_batch_pruned_replicated.launches,
                  ce.clause_counts_batch_pruned_replicated_packed.launches)
        viol, ninc = ce.clause_counts_batch_pruned_replicated(inc4, sel, lits)
        violw = ce.clause_counts_batch_pruned_replicated_packed(inc4_w, sel,
                                                                lit_w)
        assert (ce.clause_counts_batch_pruned_replicated.launches,
                ce.clause_counts_batch_pruned_replicated_packed.launches) \
            == (before[0] + 1, before[1] + 1)
        pv, pn = ce.clause_counts_batch_pruned_replicated_plain(inc4, sel,
                                                                lits)
        assert torch.equal(viol, pv) and torch.equal(ninc, pn)
        assert torch.equal(violw, viol)
        gv, gn = ce.clause_counts_batch_replicated(
            ref.gather_include(inc4, sel).reshape(R, C * M, -1), lits)
        assert torch.equal(viol, gv) and torch.equal(ninc, gn)
        assert torch.equal(violw, ce.clause_counts_batch_replicated_packed(
            ref.gather_include(inc4_w, sel).reshape(R, C * M, -1), lit_w))
        if R == 1:
            v1, n1 = ce.clause_counts_batch_pruned(inc4[0], sel[0], lits[0])
            assert torch.equal(v1, viol[0]) and torch.equal(n1, ninc[0])
            assert torch.equal(ce.clause_counts_batch_pruned_packed(
                inc4_w[0], sel[0], lit_w[0]), viol[0])


def test_pruned_kernel_rejects_out_of_range_ids(cuda):
    """Clause ids outside [0, J) made on the host are refused before any
    launch."""
    from repro_torch.kernels import clause_eval as ce

    inc = torch.zeros((2, 3, 8, 10), dtype=torch.bool, device=cuda)
    lits = torch.zeros((1, 4, 10), dtype=torch.bool, device=cuda)
    sel = torch.full((2, 3, 2), 8, dtype=torch.int32)
    before = ce.clause_counts_batch_pruned_replicated.launches
    with pytest.raises(ValueError, match="outside"):
        ce.clause_eval_batch_pruned_replicated(inc, sel, lits,
                                               training=False)
    assert ce.clause_counts_batch_pruned_replicated.launches == before


def test_tunable_fleet_through_kernels_equals_plain(cuda):
    """A K = 3 tunable fleet on the card: calibrate, then budgeted serves
    with weights and early exit, backend "cuda" (K7) against "ref", and
    full budget against plain serve."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.serve import ServiceConfig, TMService, TunableConfig

    xs, ys = iris.load()
    out = {}
    for backend in ("cuda", "ref"):
        cfg = dataclasses.replace(CONFIG.tm, backend=backend)
        svc = TMService(cfg, init_state(cfg, device=cuda), ServiceConfig(
            replicas=3, s=[1.375, 3.0, 5.0], T=[5, 15, 10],
            tunable=TunableConfig(budget=0.5, weight_bits=4,
                                  early_exit=True, group=2)),
            eval_x=xs[100:], eval_y=ys[100:], device=cuda)
        svc.offline_train(xs[:60], ys[:60], n_epochs=2)
        before = ce.clause_counts_batch_pruned_replicated.launches
        scores = svc.calibrate()
        got = [svc.serve(xs[:50], budget=b, return_aux=True)
               for b in (1.0, 0.5, 0.25)]
        plain = svc.serve(xs[:50], budget=None)
        out[backend] = (scores, [(p, a.evaluated) for p, a in got], plain,
                        ce.clause_counts_batch_pruned_replicated.launches
                        - before)
    a, r = out["cuda"], out["ref"]
    assert np.array_equal(a[0], r[0]) and np.array_equal(a[2], r[2])
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a[1], r[1]))
    assert a[3] > 0 and r[3] == 0


# The byte-operand batch body (K2, K4 and K7 on bytes: one int8
# tensor-core launch): widths across the 16-byte cp.async segment and the
# 64-byte chunk, batches across the 8-column MMA tile and the 64-column
# block tile, three placements of the operands, and bytes whose set
# values are 1, 2 or 255 (uint8) or 1, 2 or -1 (int8) beside bools.
BYTE_L = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 98, 513, 1568)
BYTE_B = (1, 7, 8, 9, 150, 1024)
BYTE_KINDS = ("bool", "uint8", "int8")
# (name, storage offset of the bank, of the literals), in elements
BYTE_PLACEMENTS = (("aligned", 0, 0), ("offset=1", 1, 1),
                   ("literals+1", 0, 1))


def _byte_plane(rng, shape, p, kind, cuda, bank=False):
    """A random 0/1 plane at density ``p`` as ``kind``; a ``bank`` gets an
    all-empty first and an all-include last row (axis -2)."""
    bits = rng.random(shape) < p
    if kind == "bool":
        t = torch.from_numpy(bits)
    else:
        vals = rng.choice((1, 2, 255) if kind == "uint8" else (1, 2, -1),
                          size=shape)
        t = torch.from_numpy(np.where(bits, vals, 0).astype(kind))
    if bank:
        t[..., 0, :] = 0
        t[..., -1, :] = {"bool": 1, "uint8": 255, "int8": -1}[kind]
    return t.to(cuda)


def _byte_cases(rng, bank_shape, lit_lead, L, cuda):
    """(bank, literals, placed bank, placed literals, what) over
    BYTE_KINDS x BYTE_B x BYTE_PLACEMENTS at width L."""
    for kind in BYTE_KINDS:
        inc = _byte_plane(rng, bank_shape + (L,), 0.1, kind, cuda, bank=True)
        for B in BYTE_B:
            lits = _byte_plane(rng, lit_lead + (B, L), 0.5, kind, cuda)
            for what, oi, ol in BYTE_PLACEMENTS:
                yield (inc, lits, _at(inc, oi), _at(lits, ol),
                       f"{kind} B={B} {what}")


@pytest.mark.parametrize("L", BYTE_L)
def test_byte_batch_count_body_equals_plain(cuda, L):
    """K2 and K4 (R = 4 on D = 2 streams, 70 rows: two row tiles) on the
    tensor-core body: one launch a call, equal to the plain versions,
    which count any nonzero byte as 1."""
    from repro_torch.kernels import clause_eval as ce

    rng = np.random.default_rng([16, L])
    for inc, lits, p_inc, p_lits, what in _byte_cases(rng, (4, 70), (2,), L,
                                                      cuda):
        before = (ce.clause_counts_batch_replicated.launches,
                  ce.clause_counts_batch.launches)
        got4 = ce.clause_counts_batch_replicated(p_inc, p_lits)
        got2 = ce.clause_counts_batch(p_inc[0], p_lits[0])
        assert (ce.clause_counts_batch_replicated.launches,
                ce.clause_counts_batch.launches) == (before[0] + 1,
                                                     before[1] + 1), what
        want4 = ce.clause_counts_batch_replicated_plain(inc, lits)
        want2 = ce.clause_counts_batch_plain(inc[0], lits[0])
        assert all(torch.equal(g, w) for g, w in zip(got4, want4)), what
        assert all(torch.equal(g, w) for g, w in zip(got2, want2)), what


@pytest.mark.parametrize("L", BYTE_L)
def test_pruned_byte_count_body_equals_plain(cuda, L):
    """K7 on bytes, replica-first (R = 4 banks of 3 x 40 on D = 2 streams)
    and K = 1, on the tensor-core body: permutation prefixes (M = 1, 20,
    40), ids with repeats (M = 20), each as int32 and int64, taken in
    turn; one launch a call, equal to the plain versions."""
    from repro_torch.kernels import clause_eval as ce

    R, C, J = 4, 3, 40
    rng = np.random.default_rng([7, L])
    sels = [np.stack([np.stack([rng.permutation(J)[:M] for _ in range(C)])
                      for _ in range(R)]) for M in (1, J // 2, J)]
    rep = rng.integers(0, J, (R, C, J // 2))
    rep[..., -1] = rep[..., 0]
    sels.append(rep)
    sels = [torch.from_numpy(s.astype(dt)).to(cuda) for s in sels
            for dt in (np.int32, np.int64)]
    cases = _byte_cases(rng, (R, C, J), (2,), L, cuda)
    for i, (inc, lits, p_inc, p_lits, what) in enumerate(cases):
        sel = sels[i % len(sels)]
        what = f"M={sel.shape[-1]} {sel.dtype} {what}"
        before = (ce.clause_counts_batch_pruned_replicated.launches,
                  ce.clause_counts_batch_pruned.launches)
        got = ce.clause_counts_batch_pruned_replicated(p_inc, sel, p_lits)
        one = ce.clause_counts_batch_pruned(p_inc[0], sel[0], p_lits[0])
        assert (ce.clause_counts_batch_pruned_replicated.launches,
                ce.clause_counts_batch_pruned.launches) == (before[0] + 1,
                                                            before[1] + 1)
        want = ce.clause_counts_batch_pruned_replicated_plain(inc, sel, lits)
        want1 = ce.clause_counts_batch_pruned_plain(inc[0], sel[0], lits[0])
        assert all(torch.equal(g, w) for g, w in zip(got, want)), what
        assert all(torch.equal(g, w) for g, w in zip(one, want1)), what


@pytest.mark.parametrize("L", BYTE_L)
def test_byte_count_body_large_tiles_equal_plain(cuda, L):
    """Grids of 8 or more 64 x 64 tiles an SM take the body's 128 x 128
    tiles: K4 and K7 on bytes at R = 16 banks of 300 ragged rows (K7: 3
    classes of 120 clauses, 100 elected) against B = 1000, equal to the
    plain versions, one launch a call."""
    from repro_torch.kernels import clause_eval as ce

    R, C, J, M, B = 16, 3, 120, 100, 1000
    rng = np.random.default_rng([128, L])
    sels = [torch.from_numpy(s.astype(dt)).to(cuda) for s in (
        np.stack([np.stack([rng.permutation(J)[:M] for _ in range(C)])
                  for _ in range(R)]),
        rng.integers(0, J, (R, C, M))) for dt in (np.int32, np.int64)]
    for i, kind in enumerate(BYTE_KINDS):
        inc = _byte_plane(rng, (R, C, J, L), 0.1, kind, cuda, bank=True)
        lits = _byte_plane(rng, (2, B, L), 0.5, kind, cuda)
        rows = inc[:, :, :M].reshape(R, C * M, L)
        for j, (what, oi, ol) in enumerate(BYTE_PLACEMENTS):
            sel = sels[(3 * i + j) % len(sels)]
            before = (ce.clause_counts_batch_replicated.launches,
                      ce.clause_counts_batch_pruned_replicated.launches)
            got4 = ce.clause_counts_batch_replicated(_at(rows, oi),
                                                     _at(lits, ol))
            got7 = ce.clause_counts_batch_pruned_replicated(_at(inc, oi), sel,
                                                            _at(lits, ol))
            assert (ce.clause_counts_batch_replicated.launches,
                    ce.clause_counts_batch_pruned_replicated.launches) == (
                before[0] + 1, before[1] + 1)
            want4 = ce.clause_counts_batch_replicated_plain(rows, lits)
            want7 = ce.clause_counts_batch_pruned_replicated_plain(inc, sel,
                                                                   lits)
            assert all(torch.equal(g, w) for g, w in zip(got4, want4)), (
                kind, what)
            assert all(torch.equal(g, w) for g, w in zip(got7, want7)), (
                kind, what, sel.dtype)


# The word body (K5, K6 and K7 on words: one b1 tensor-core launch):
# widths on its 4-, 8- and 16-byte copies, the 8-word b1 step, the
# 16-word chunk and beyond the old shared-memory cap (700), batches
# across the 8-column MMA tile and the 64-column block tile, aligned
# operands and operands 4 and 8 bytes off alignment, and three kinds of
# words: random; all-ones include words against literal rows of zeros,
# ones and random words (sums up to 32 W); include words with tail bits
# set against literals with them clear.
WORD_W = (1, 2, 3, 7, 8, 9, 50, 98, 700)
WORD_KINDS = ("random", "ones", "tail")
# (name, storage offset of the bank, of the literals), in int32 words
WORD_PLACEMENTS = (("aligned", 0, 0), ("4 bytes off", 1, 1),
                   ("8 bytes off", 2, 2), ("literals 8 bytes off", 0, 2))


def _words(rng, shape, kind, cuda, bank=False):
    """uint32 words [*shape] of ``kind`` as int32 on the card; a ``bank``
    (include words) gets an all-zero first and an all-ones last row."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    if bank:
        if kind == "ones":
            w[...] = 0xFFFFFFFF
        elif kind == "tail":
            w[..., -1] |= np.uint32(0xFFFF0000)
        w[..., 0, :] = 0
        w[..., -1, :] = 0xFFFFFFFF
    elif kind == "ones":
        w[..., 0::3, :] = 0
        w[..., 1::3, :] = 0xFFFFFFFF
    elif kind == "tail":
        w[..., -1] &= np.uint32(0x0000FFFF)
    return torch.from_numpy(w.view(np.int32)).to(cuda)


def _word_cases(rng, bank_shape, lit_lead, W, cuda, batches=BYTE_B):
    """(bank, literals, what) over WORD_KINDS x ``batches`` at width W."""
    for kind in WORD_KINDS:
        inc = _words(rng, bank_shape + (W,), kind, cuda, bank=True)
        for B in batches:
            yield inc, _words(rng, lit_lead + (B, W), kind, cuda), \
                f"{kind} B={B}"


def _by_replica(plain, inc, lits, sel=None):
    """A replica-first plain version replica by replica (its temporaries
    grow with R x rows x B x W)."""
    D = lits.shape[0]
    return torch.cat([
        plain(inc[r:r + 1], lits[r % D:r % D + 1]) if sel is None
        else plain(inc[r:r + 1], sel[r:r + 1], lits[r % D:r % D + 1])
        for r in range(inc.shape[0])])


def _word_sels(rng, R, C, J, Ms, cuda):
    """int32 and int64 selections [R, C, M]: permutation prefixes at each
    M and ids with repeats at the middle one, each holding ids 0 and
    J - 1."""
    out = [np.stack([np.stack([rng.permutation(J)[:M] for _ in range(C)])
                     for _ in range(R)]) for M in Ms]
    rep = rng.integers(0, J, (R, C, Ms[len(Ms) // 2]))
    rep[..., -1] = rep[..., 0]
    out.append(rep)
    for a in out:
        a[:, 0, 0] = 0
        a[:, -1, -1] = J - 1
    return [torch.from_numpy(a.astype(dt)).to(cuda) for a in out
            for dt in (np.int32, np.int64)]


@pytest.mark.parametrize("W", WORD_W)
def test_word_batch_count_body_equals_plain(cuda, W):
    """K6 (R = 4 banks of 70 rows on D = 2 streams) and K5 on the b1
    tensor-core body: one launch a call, equal to the plain versions, on
    int32 and uint32 word tensors."""
    from repro_torch.kernels import clause_eval as ce

    rng = np.random.default_rng([17, W])
    for inc, lits, what in _word_cases(rng, (4, 70), (2,), W, cuda):
        want6 = _by_replica(ce.clause_counts_batch_replicated_packed_plain,
                            inc, lits)
        want5 = ce.clause_counts_batch_packed_plain(inc[0], lits[0])
        for where, oi, ol in WORD_PLACEMENTS:
            p_inc, p_lits = _at(inc, oi), _at(lits, ol)
            before = (ce.clause_counts_batch_replicated_packed.launches,
                      ce.clause_counts_batch_packed.launches)
            got6 = ce.clause_counts_batch_replicated_packed(p_inc, p_lits)
            got5 = ce.clause_counts_batch_packed(p_inc[0], p_lits[0])
            assert (ce.clause_counts_batch_replicated_packed.launches,
                    ce.clause_counts_batch_packed.launches) == (
                before[0] + 1, before[1] + 1)
            assert torch.equal(got6, want6), (what, where)
            assert torch.equal(got5, want5), (what, where)
        got_u = ce.clause_counts_batch_packed(inc[0].view(torch.uint32),
                                              lits[0].view(torch.uint32))
        assert torch.equal(got_u, want5), what


@pytest.mark.parametrize("W", WORD_W)
def test_pruned_word_count_body_equals_plain(cuda, W):
    """K7 on words, replica-first (R = 4 banks of 3 x 40 clauses on D = 2
    streams) and K = 1, on the b1 body: int32 and int64 selections taken
    in turn, holding ids 0 and J - 1; one launch a call, equal to the
    plain versions and to gather + K6 (K = 1: gather + K5)."""
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import ref

    R, C, J = 4, 3, 40
    rng = np.random.default_rng([18, W])
    sels = _word_sels(rng, R, C, J, (1, J // 2, J), cuda)
    turn = 0
    for inc, lits, what in _word_cases(rng, (R, C, J), (2,), W, cuda):
        for where, oi, ol in WORD_PLACEMENTS:
            sel = sels[turn % len(sels)]
            turn += 1
            p_inc, p_lits = _at(inc, oi), _at(lits, ol)
            before = (ce.clause_counts_batch_pruned_replicated_packed.launches,
                      ce.clause_counts_batch_pruned_packed.launches)
            got = ce.clause_counts_batch_pruned_replicated_packed(p_inc, sel,
                                                                  p_lits)
            one = ce.clause_counts_batch_pruned_packed(p_inc[0], sel[0],
                                                       p_lits[0])
            assert (ce.clause_counts_batch_pruned_replicated_packed.launches,
                    ce.clause_counts_batch_pruned_packed.launches) == (
                before[0] + 1, before[1] + 1)
            want = _by_replica(
                ce.clause_counts_batch_pruned_replicated_packed_plain, inc,
                lits, sel)
            gath = ce.clause_counts_batch_replicated_packed(
                ref.gather_include(inc, sel).reshape(R, -1, W), lits)
            gath1 = ce.clause_counts_batch_packed(
                ref.gather_include(inc[0], sel[0]).reshape(-1, W), lits[0])
            tag = (what, where, sel.dtype, sel.shape[-1])
            assert torch.equal(got, want), tag
            assert torch.equal(got, gath), tag
            assert torch.equal(one, want[0]), tag
            assert torch.equal(one, gath1), tag


@pytest.mark.parametrize("W", WORD_W)
def test_word_count_body_large_tiles_equal_plain(cuda, W):
    """Grids of 8 or more 64 x 64 tiles an SM take the body's 128 x 128
    tiles: K6 and K7 on words at R = 16 banks of 300 ragged rows (K7: 3
    classes of 120 clauses, 100 elected) against B = 1000, equal to the
    plain versions, one launch a call."""
    from repro_torch.kernels import clause_eval as ce

    R, C, J, M, B = 16, 3, 120, 100, 1000
    rng = np.random.default_rng([19, W])
    sels = _word_sels(rng, R, C, J, (M,), cuda)
    for i, kind in enumerate(WORD_KINDS):
        inc = _words(rng, (R, C, J, W), kind, cuda, bank=True)
        lits = _words(rng, (2, B, W), kind, cuda)
        rows = inc[:, :, :M].reshape(R, C * M, W)
        want6 = _by_replica(ce.clause_counts_batch_replicated_packed_plain,
                            rows, lits)
        for j, (where, oi, ol) in enumerate(WORD_PLACEMENTS):
            sel = sels[(4 * i + j) % len(sels)]
            before = (ce.clause_counts_batch_replicated_packed.launches,
                      ce.clause_counts_batch_pruned_replicated_packed.launches)
            got6 = ce.clause_counts_batch_replicated_packed(_at(rows, oi),
                                                            _at(lits, ol))
            got7 = ce.clause_counts_batch_pruned_replicated_packed(
                _at(inc, oi), sel, _at(lits, ol))
            assert (ce.clause_counts_batch_replicated_packed.launches,
                    ce.clause_counts_batch_pruned_replicated_packed.launches
                    ) == (before[0] + 1, before[1] + 1)
            want7 = _by_replica(
                ce.clause_counts_batch_pruned_replicated_packed_plain, inc,
                lits, sel)
            assert torch.equal(got6, want6), (kind, where)
            assert torch.equal(got7, want7), (kind, where, sel.dtype)


def _res_service(device, resident, *, packed=False, batched=True):
    """K = 6 iris-width machines on ``resident`` slots (the reference's
    residency test geometry), drain-only."""
    from repro_torch.core import TMConfig, init_state
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    cfg = TMConfig(n_features=16, max_classes=3, max_clauses=16,
                   n_states=16, backend="cuda")
    return TMService(cfg, init_state(cfg, device=device), ServiceConfig(
        replicas=6, buffer_capacity=8, chunk=4, ingress_block=4,
        packed=packed, s=3.0, T=15, seed=7, resident=resident,
        batched_moves=batched, policy=AdaptPolicy(analyze_every=10 ** 9)),
        device=device)


def _res_fleet(svc) -> list:
    """The logical fleet on the host: assembled banks, rings, steps, keys."""
    ss = svc.ss
    return [a.cpu() for a in (ss.tm.ta_state, *ss.buf, ss.step)] + [
        torch.from_numpy(svc.rng_keys.astype(np.int64)),
        torch.from_numpy(svc.steps)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("batched", [True, False])
def test_residency_on_card_equals_cpu(cuda, packed, batched):
    """K = 6 on 2 slots on the card (kernels, pinned moves and events, or
    the synchronous moves) against the same service on the CPU (the plain
    versions), bit for bit: the logical fleet, the placement and served
    predictions."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        svc = _res_service(dev, 2, packed=packed, batched=batched)
        rng = np.random.default_rng(3)
        for i in range(40):
            svc.submit_rows(rng.random(16) > 0.5, int(rng.integers(0, 3)))
            if i % 4 == 3:
                svc.tick()
        assert svc._res.evictions > 10
        preds = svc.serve_replicas([0, 3, 5], rng.random((5, 16)) > 0.5)
        out[dev.type] = (_res_fleet(svc), svc._res.slot_of.copy(), preds)
    a, c = out["cuda"], out["cpu"]
    assert all(torch.equal(x, y) for x, y in zip(a[0], c[0]))
    assert np.array_equal(a[1], c[1]) and np.array_equal(a[2], c[2])


def test_deferred_spill_survives_a_drain_before_settling(cuda):
    """A spill issued (a gather into pinned host memory, an event) behind a
    stream held busy, so its copy has not run when the issue returns: the
    event is not done, and awaiting it alone (no other synchronisation)
    gives the replica's rows bitwise. Then at once a drain that rewrites
    the plane before the spill settles: the snapshot that settles is the
    replica's state at the spill, bitwise its always-resident twin's, held
    in pageable memory of its own, and so is the whole fleet."""
    from repro_torch import tree as T
    from repro_torch.core import online

    res, twin = _res_service(cuda, 3), _res_service(cuda, None)
    rng = np.random.default_rng(5)
    for i in range(24):
        x, y = rng.random(16) > 0.5, int(rng.integers(0, 3))
        res.submit_rows(x, y)
        twin.submit_rows(x, y)
        if i % 4 == 3:
            res.flush()
            drive = res.buffered > 0
            res.tick()
            twin.tick(np.where(drive, twin.chunk, 0))
    res.activate([0, 1, 2])
    mask = np.array([False, True, True, False, False, False])
    for x, y in ((rng.random(16) > 0.5, 1), (rng.random(16) > 0.5, 2)):
        res.submit_rows(x, y, mask)
        twin.submit_rows(x, y, mask)
    res.flush()
    drive = res.buffered > 0
    assert not drive[0] and drive[1] and drive[2]
    tss = twin.ss
    want = [a.cpu().numpy() for a in (tss.tm.ta_state[0],
                                      *(a[0] for a in tss.buf),
                                      tss.step[0], twin._keys[0])]
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 29)     # hold the stream: the copy waits
    res._spill_issue([res._res.slot_of[0]])
    gather, _ = res._pending_spills[0]
    assert gather.event is not None and not gather.event.query()
    assert all(h.is_pinned() for h in T.leaves(gather.host))
    snap, key = online.gather_replicas_await(gather)
    assert gather.event.query()
    for got, w in zip((snap.tm.ta_state, *snap.buf, snap.step, key), want):
        assert np.array_equal(np.asarray(got)[0], w)
    before = res._ss.tm.ta_state.clone()
    res.drain(4)                   # rewrites the plane, then settles
    twin.drain(np.where(drive, 4, 0))
    assert not torch.equal(res._ss.tm.ta_state, before)
    assert not res._pending_spills and not res.resident[0]
    snap, key = res._res.store[0]
    leaves = (snap.tm.ta_state, *snap.buf, snap.step, key)
    assert all(isinstance(a, np.generic) or a.flags.owndata
               for a in leaves)
    for got, w in zip(leaves, want):
        assert np.array_equal(np.asarray(got), w)
    assert all(torch.equal(x, y)
               for x, y in zip(_res_fleet(res), _res_fleet(twin)))


def test_filter_masks_land_on_the_card(cuda):
    """``limit_mask`` with an int limit and ``class_filter_mask`` of host
    labels, with no device named, run on the card, equal to the CPU's."""
    from repro_torch.data import filter as filt

    m = filt.limit_mask(30, 20)
    assert m.device.type == "cuda"
    assert torch.equal(m.cpu(), filt.limit_mask(30, 20, "cpu"))
    ys = [0, 1, 2, 1, 0]
    c = filt.class_filter_mask(ys, 1, True)
    assert c.device.type == "cuda"
    assert torch.equal(c.cpu(), filt.class_filter_mask(ys, 1, True,
                                                       device="cpu"))


# The LM substrate on the card against the CPU port. It has no CUDA kernel
# of its own (plain PyTorch ops); these hold the card's float32 results to
# the CPU's: max |card - cpu| <= 1e-4 * max |cpu| (TF32 off, torch's
# default), and tokens equal unless the CPU's top-2 gap at the first
# differing step is within that tolerance.
LM_TOL = 1e-4


def _lm_pair(cuda, arch="gemma3_1b"):
    from repro_torch import configs
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    tree = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
    return (cfg, tree, transformer.Transformer(cfg, tree, device="cpu"),
            transformer.Transformer(cfg, tree, device=cuda))


def _lm_close(got, want):
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= LM_TOL * want.float().abs().max().item(), err


def test_lm_gemma3_smoke_on_card_equals_cpu(cuda):
    """forward, prefill (logits and the cache, key for key; a prompt past
    the 8-slot window) and decode steps that wrap it."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, _, cpu, gpu = _lm_pair(cuda)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    _lm_close(gpu({"tokens": toks.to(cuda)})[0], cpu({"tokens": toks})[0])
    lc, cc = cpu.prefill({"tokens": toks[:, :12]}, 24)
    lg, cg = gpu.prefill({"tokens": toks[:, :12].to(cuda)}, 24)
    _lm_close(lg, lc)
    for top in cc:
        for name in cc[top]:
            for k in ("k", "v"):
                _lm_close(cg[top][name][k], cc[top][name][k])
    for i in range(12, 20):
        lc, cc = cpu.decode_step({"token": toks[:, i:i + 1], "pos": i}, cc)
        lg, cg = gpu.decode_step({"token": toks[:, i:i + 1].to(cuda),
                                  "pos": i}, cg)
        _lm_close(lg, lc)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_lm_generate_on_card_equals_cpu(cuda, temperature):
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg, tree, cpu, _ = _lm_pair(cuda)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ec = EngineConfig(max_seq=18, batch_slots=2, temperature=temperature)
    want = Engine(cfg, tree, ec, seed=5, device="cpu").generate(prompts, 12)
    got = Engine(cfg, tree, ec, seed=5, device=cuda).generate(prompts, 12)
    from repro_torch import random as R

    for b in range(2):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        # only at a near-tie of the CPU's decision values at that step:
        # its logits, or its gumbel noise plus logits / T
        i = int(diff[0])
        toks = torch.from_numpy(np.concatenate(
            [prompts, want[:, :i]], axis=1).astype(np.int64))
        logits = cpu({"tokens": toks})[0][:, -1]
        scale = logits.abs().max()
        if temperature > 0:
            key = R.PRNGKey(5)
            for _ in range(i + 1):
                key, k = R.split(key)
            logits = R.gumbel(k, logits.shape) + logits / torch.tensor(
                temperature)
            scale = scale / temperature
        top2 = torch.topk(logits[b], 2).values
        assert top2[0] - top2[1] <= LM_TOL * scale, (b, i)


# The LM training path on the card against the CPU (plain PyTorch ops, the
# streaming-softmax backward included): float32, TF32 off, max |card - cpu|
# <= LM_TOL * max |cpu| per tensor or leaf.


@pytest.mark.parametrize("window", [None, 8])
def test_lm_flash_backward_on_card_equals_cpu(cuda, window):
    from repro_torch.models import layers

    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((2, 32, 4, 16))).float()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 32, 1, 16))).float()
            for _ in range(2))
    out = []
    for where in ("cpu", cuda):
        xs = [x.to(where).requires_grad_() for x in (q, k, v)]
        o = layers._Flash.apply(*xs, window, 8)
        out.append([o] + list(torch.autograd.grad(o, xs, do.to(where))))
    for g, c in zip(out[1], out[0]):
        _lm_close(g.detach(), c.detach())


def _lm_train_tree(cfg, device):
    """The smoke model's parameters on ``device``, each stacked layer drawn
    with its own fan-in (at materialize's one-super-block std 1, float32
    gradients are ill-conditioned; tests/test_torch_lm_train.py)."""
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    def walk(spec, node):
        if isinstance(spec, P.PSpec):
            if spec.init == "normal" and spec.axes[0] == "layers":
                node.mul_((spec.shape[0] / spec.shape[1]) ** 0.5)
            return node.to(device)
        return {k: walk(spec[k], node[k]) for k in spec}

    specs = transformer.model_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    return walk(specs, P.materialize(specs, gen, device="cpu"))


@pytest.mark.parametrize("case", ["adamw", "sgd_microbatches"])
def test_lm_train_step_on_card_equals_cpu(cuda, case):
    """One gemma3 smoke train step (S = 32, attn_chunk 8 so every layer
    takes the streaming path) on the card and on the CPU from the same
    state: the loss, gradients, moments and parameters within LM_TOL. AdamW's
    first step lr * g / (|g| + eps) turns a gradient difference within
    LM_TOL into a step difference up to lr * eps * |dg| / (|g| + eps)^2,
    large where |g| is near eps: where the step difference that the two
    runs' first moments and second moments imply (each from the gradient
    its step used, g = mu / (1 - b1)) is beyond LM_TOL, the parameters are
    held within LM_TOL of that prediction instead, and each such element
    is printed with both gradients. On the card remat dots gives the same
    gradient bits as no remat."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(configs.get_smoke_config("gemma3_1b"),
                              attn_chunk=8)
    tc = (TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1))
          if case == "adamw" else
          TS.TrainConfig(opt=opt.OptConfig(name="sgd", lr=1e-3,
                                           warmup_steps=1),
                         microbatches=2))
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 32))}
    trees = [_lm_train_tree(cfg, d) for d in ("cpu", cuda)]
    grads = [TS.grad_fn(cfg, tc, t, batch) for t in trees]
    _lm_close(grads[1][0], grads[0][0])
    for g, c in zip(T.leaves(grads[1][2]), T.leaves(grads[0][2])):
        _lm_close(g, c)
    out = [TS.train_step(cfg, tc, TS.init_state(tc, t), batch) for t in trees]
    _lm_close(out[1][1]["loss"], out[0][1]["loss"])
    for part in ("mu", "nu"):
        for g, c in zip(T.leaves(getattr(out[1][0].opt, part)),
                        T.leaves(getattr(out[0][0].opt, part))):
            if c.abs().max() > 0:
                _lm_close(g, c)
    lr, oc = out[0][1]["lr"].item(), tc.opt

    def adam_step(m, v):     # apply's first AdamW step (t = 1)
        m, v = m.cpu().float(), v.cpu().float()
        return (m / (1 - oc.b1)) / (torch.sqrt(v / (1 - oc.b2)) + oc.eps)

    def paths(tree, pre=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in paths(tree[k],
                                                           f"{pre}{k}.")]
        return [pre[:-1]]

    amplified, flipped = [], 0
    card, host = out[1][0], out[0][0]
    for name, p, q, mg, mc, vg, vc in zip(
            paths(trees[0]), T.leaves(card.params), T.leaves(host.params),
            T.leaves(card.opt.mu), T.leaves(host.opt.mu),
            T.leaves(card.opt.nu), T.leaves(host.opt.nu)):
        gap, tol = p.cpu() - q, LM_TOL * q.abs().max().item()
        if case == "adamw":
            pred = -lr * (adam_step(mg, vg) - adam_step(mc, vc))
            gg, gc = mg.cpu() / (1 - oc.b1), mc / (1 - oc.b1)
            amp = pred.abs() > tol
            for i in amp.nonzero().tolist():
                i = tuple(i)
                amplified.append(
                    f"{name}{list(i)}: card g {gg[i].item():.3e}, CPU g "
                    f"{gc[i].item():.3e}, parameter gap {gap[i].item():.3e} "
                    f"(predicted {pred[i].item():.3e})")
            flipped += int((torch.sign(gg) != torch.sign(gc)).sum())
            gap = torch.where(amp, gap - pred, gap)
        err = gap.abs().max().item()
        assert err <= tol, (name, err)
    print(f"{case}: {len(amplified)} elements held to AdamW's predicted "
          f"step difference ({flipped} gradients of opposite sign)"
          + "".join("\n  " + a for a in amplified))
    remat = [TS.grad_fn(dataclasses.replace(cfg, remat=r), tc, trees[1],
                        batch)[2] for r in ("none", "dots")]
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(remat[0]),
                                                 T.leaves(remat[1])))



def test_lm_online_adapt_rollback_on_card(cuda, tmp_path):
    """The LM online-adapt FSM on the card (tests/test_torch_lm_train.py's
    twin of the reference's rollback test runs it on the CPU): offline
    training checkpoints the state, updates at a ruinous learning rate
    make the analysis restore it, bit for bit, on the card. The offline
    eval loss equals the CPU run's within LM_TOL, and both runs roll back
    as often."""
    import dataclasses

    from repro_torch import configs, convert
    from repro_torch import tree as T
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serve.online_adapt import (OnlineAdaptConfig,
                                                OnlineAdaptManager)
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as TS

    cfg = configs.get_smoke_config("gemma3_1b")
    tc = TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=1000))
    tc_bad = dataclasses.replace(tc, opt=dataclasses.replace(tc.opt, lr=0.5))
    rng = np.random.default_rng(1)
    good, evalb, bad = ({"tokens": rng.integers(0, cfg.vocab_size, (2, 32))}
                        for _ in range(3))
    runs = []
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(0)
        prm = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
        oc = OnlineAdaptConfig(analyze_every=2, rollback_threshold=0.05,
                               checkpoint_dir=str(tmp_path / str(dev)))
        m = OnlineAdaptManager(cfg, tc, TS.init_state(tc, prm), oc,
                               device=dev)
        base = m.offline_train([good, good], evalb)
        saved = convert.lm_train_state_to_numpy(m.state)
        m._update = lambda s, b: TS.train_step(cfg, tc_bad, s, b)
        for _ in range(6):
            m.online_step(bad, evalb)
        runs.append((m, base, saved))
    (m_cpu, base_cpu, _), (m, base, saved) = runs
    assert m.state.opt.step.device.type == "cuda"
    _lm_close(torch.tensor(base), torch.tensor(base_cpu))
    assert m.rollbacks == m_cpu.rollbacks >= 1, (m.history, m_cpu.history)
    assert m.history[-1][1] > base * (1 + oc.rollback_threshold)
    now = convert.lm_train_state_to_numpy(m.state)
    assert all(np.array_equal(a, b) for a, b in zip(T.leaves(saved),
                                                    T.leaves(now)))

def test_grad_compression_on_card_equals_cpu_bitwise(cuda):
    """int8 compression with error feedback is the same bits on the card
    as on the CPU for the same float32 inputs (round half to even, the
    scale divided by a tensor)."""
    from repro_torch.distributed import collectives as C

    rng = np.random.default_rng(8)
    for scale in (1e-6, 1e-2, 1e3):
        g = {"w": torch.from_numpy((rng.standard_normal((64, 33)) * scale)
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}
        r = {k: torch.from_numpy((rng.standard_normal(v.shape) * 1e-3 * scale)
                                 .astype(np.float32)) for k, v in g.items()}
        want = C.compress_grads(g, C.CompressionState(r))
        got = C.compress_grads({k: v.to(cuda) for k, v in g.items()},
                               C.CompressionState({k: v.to(cuda)
                                                   for k, v in r.items()}))
        for k in g:
            assert torch.equal(got[0][k].cpu(), want[0][k])
            assert torch.equal(got[1].residual[k].cpu(), want[1].residual[k])


# The MoE FFN and the SSD block on the card against the CPU (plain PyTorch
# ops; no CUDA kernel of their own), at the smoke widths.


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b",
                                  "mamba2_780m"])
def test_lm_moe_ssd_on_card_equals_cpu(cuda, arch):
    """forward, prefill (logits and every cache leaf: K/V, the SSD state
    and conv tail) and 4 decode steps at the config's capacity, float32
    within LM_TOL; each MoE router's (expert_idx, pos, keep) equal as
    integers on both devices."""
    from repro_torch.models import moe

    cfg, _, cpu, gpu = _lm_pair(cuda, arch)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)))
    routes = {"cpu": [], "cuda": []}
    route = moe.route

    def recorded(c, p, xt):
        r = route(c, p, xt)
        routes[xt.device.type].append([x.cpu() for x in r[:3]])
        return r

    moe.route = recorded
    try:
        _lm_close(gpu({"tokens": toks.to(cuda)})[0], cpu({"tokens": toks})[0])
        lc, cc = cpu.prefill({"tokens": toks[:, :12]}, 24)
        lg, cg = gpu.prefill({"tokens": toks[:, :12].to(cuda)}, 24)
        _lm_close(lg, lc)
        for top in cc:
            for name in cc[top]:
                for k in cc[top][name]:
                    _lm_close(cg[top][name][k], cc[top][name][k])
        for i in range(12, 16):
            lc, cc = cpu.decode_step({"token": toks[:, i:i + 1], "pos": i},
                                     cc)
            lg, cg = gpu.decode_step({"token": toks[:, i:i + 1].to(cuda),
                                      "pos": i}, cg)
            _lm_close(lg, lc)
    finally:
        moe.route = route
    assert len(routes["cpu"]) == len(routes["cuda"])
    for a, b in zip(routes["cpu"], routes["cuda"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_780m"])
def test_lm_moe_ssd_gradients_on_card_equal_cpu(cuda, arch):
    """The loss (router aux included) and every gradient leaf of one
    smoke batch, with two MoE dispatch groups, at float64 compute (the
    card and the CPU evaluate the same function; no routing near-tie can
    split them) within LM_TOL."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="float64")
    tc = TS.TrainConfig(moe_num_groups=2)
    batch = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32))}
    out = [TS.grad_fn(cfg, tc, _lm_train_tree(cfg, d), batch)
           for d in ("cpu", cuda)]
    _lm_close(out[1][0], out[0][0])
    _lm_close(out[1][1]["aux"], out[0][1]["aux"])
    for g, c in zip(T.leaves(out[1][2]), T.leaves(out[0][2])):
        _lm_close(g, c)


# The RG-LRU block and the gated cross-attention on the card against the
# CPU (plain PyTorch ops; no CUDA kernel of their own), at the smoke widths,
# each layer at its own fan-in and the leaves whose constant inits would
# hide a fault (a CROSS layer's gates, zeros, make it an identity; the
# RG-LRU's biases and Lambda) moved off them by U(-1, 1).


def _lm_drawn_tree(cfg, device):
    tree = _lm_train_tree(cfg, "cpu")
    gen = torch.Generator().manual_seed(1)

    def draw(path, node):
        if isinstance(node, dict):
            return {k: draw(path + (k,), v) for k, v in node.items()}
        if path[-1] in ("gate", "ffn_gate") or (
                "rec" in path and path[-1] in ("conv_b", "b_a", "b_x",
                                               "lambda_p")):
            node = node + (2 * torch.rand(node.shape, generator=gen) - 1)
        return node.to(device)

    return draw((), tree)


def _lm_batch(cfg, B, S, seed, device):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(device)}
    if cfg.family == "vlm":
        out["cross_embeds"] = torch.from_numpy(0.5 * rng.standard_normal(
            (B, cfg.n_cross_tokens, cfg.d_model))).float().to(device)
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "llama32_vision_11b"])
def test_lm_rglru_cross_on_card_equals_cpu(cuda, arch):
    """forward, prefill (logits and every cache leaf: the RG-LRU state and
    conv tail, the LOCAL window, the CROSS ``ck``/``cv``) and 4 decode
    steps past recurrentgemma's 8-slot window, float32 within LM_TOL."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config(arch)
    cpu = transformer.Transformer(cfg, _lm_drawn_tree(cfg, "cpu"),
                                  device="cpu")
    gpu = transformer.Transformer(cfg, _lm_drawn_tree(cfg, cuda),
                                  device=cuda)
    bc = _lm_batch(cfg, 2, 16, 4, "cpu")
    bg = {k: v.to(cuda) for k, v in bc.items()}
    _lm_close(gpu(bg)[0], cpu(bc)[0])

    def cut(b, n):
        return {k: v if k == "cross_embeds" else v[:, :n]
                for k, v in b.items()}

    lc, cc = cpu.prefill(cut(bc, 12), 24)
    lg, cg = gpu.prefill(cut(bg, 12), 24)
    _lm_close(lg, lc)
    for top in cc:
        for name in cc[top]:
            for k in cc[top][name]:
                _lm_close(cg[top][name][k], cc[top][name][k])
    for i in range(12, 16):
        lc, cc = cpu.decode_step({"token": bc["tokens"][:, i:i + 1],
                                  "pos": i}, cc)
        lg, cg = gpu.decode_step({"token": bg["tokens"][:, i:i + 1],
                                  "pos": i}, cg)
        _lm_close(lg, lc)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "llama32_vision_11b"])
def test_lm_rglru_cross_train_step_on_card_equals_cpu(cuda, arch):
    """One AdamW ``train_step`` of the smoke model at float64 compute (a
    vlm batch with ``cross_embeds``), on the card and on the CPU from the
    same state: the loss, gradient norm, parameters and both moments
    within LM_TOL."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="float64")
    tc = TS.TrainConfig()
    batch = {k: v.numpy() for k, v in _lm_batch(cfg, 2, 32, 5,
                                                "cpu").items()}
    out = []
    for d in ("cpu", cuda):
        st, m = TS.train_step(cfg, tc, TS.init_state(
            tc, _lm_drawn_tree(cfg, d)), batch)
        out.append((m, st))
    (mc, sc), (mg, sg) = out
    for k in ("loss", "grad_norm"):
        _lm_close(mg[k], mc[k])
    for g, c in zip(T.leaves((sg.params, sg.opt.mu, sg.opt.nu)),
                    T.leaves((sc.params, sc.opt.mu, sc.opt.nu))):
        _lm_close(g, c)


# -- the LM half of the mesh: 4 ranks on the card(s) -----------------------

MESH_PLAN = {"train": [("adamw", (2, 2))], "reshard": [(4, 1)]}


def _mesh_inputs(arch):
    from repro_torch import configs
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config(arch)
    rng = np.random.default_rng(11)

    def walk(spec):
        if isinstance(spec, P.PSpec):
            if spec.init in ("zeros", "ones"):
                return np.full(spec.shape, spec.init == "ones", np.float32)
            shape = spec.shape[1:] if spec.axes[0] == "layers" else spec.shape
            fan = shape[0] if len(shape) > 1 else max(shape[0], 1)
            return (spec.scale / np.sqrt(fan) * rng.standard_normal(
                spec.shape)).astype(np.float32)
        return {k: walk(spec[k]) for k in sorted(spec)}

    prm = walk(transformer.model_specs(cfg))
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(
        np.int32)} for _ in range(4)]
    return cfg, prm, batches


def _adamw_close(got, want, floor, what):
    """Within 1e-4 of the leaf's range, save elements whose gap is within
    ``floor``: for parameters AdamW's own reach for noise-level gradients
    (2 x the summed learning rate: each step moves an element by about lr
    whatever its gradient's size), for moments 1e-4 of the largest moment
    of the tree (a leaf whose gradients cancel to near zero carries the
    float32 noise of its larger terms, which the ranks sum in another
    order)."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    gap = np.abs(a - b)
    ok = (gap <= 1e-4 * (np.max(np.abs(b)) or 1.0)) | (gap <= floor)
    assert ok.all(), f"{what}: {gap.max():.3e}"


@pytest.mark.parametrize("arch", ["gemma3_1b", "olmoe_1b_7b"])
def test_lm_sharded_train_steps_on_card_equal_unsharded(cuda, arch,
                                                        tmp_path):
    """4 ranks on the card(s) (one card: the staged backend; 4 or more:
    NCCL), smoke config on a (2, 2) mesh: 3 AdamW steps and a resume on
    (4, 1) with a 4th, against the unsharded port on ``cuda``: losses
    within 1e-5 relative; moments and parameters within 1e-4 of their
    leaf's range, save the noise-level elements ``_adamw_close`` names.
    For olmoe the state is held after the first step only: the two runs'
    float32 router logits differ in the last bits (other products, other
    sums), and once a token at a near-tie takes another expert its
    embedding row's moment moves by far more than the noise (seen at step
    3 on an H100); the CPU test holds all three steps."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_lm_mesh_ranks as R

    from repro_torch import tree as T
    from repro_torch.launch import ranks
    from repro_torch.train import train_step as TS

    cfg, prm, batches = _mesh_inputs(arch)
    out = ranks.spawn(R.run, 4, (arch, prm, batches, MESH_PLAN,
                                 str(tmp_path), "cuda"), device="cuda",
                      timeout_s=120)[0]
    groups = 2 if cfg.moe is not None else 1
    tc = R.train_config(cfg, "adamw", groups)
    state = TS.init_state(tc, T.map(lambda x: torch.tensor(x, device=cuda),
                                    prm))
    lr_sum = 0.0
    for k in range(4):
        state, m = TS.train_step(cfg, tc, state, batches[k])
        lr_sum += float(m["lr"])
        if k < 3:
            got, gm = out["train"]["adamw"][k]
            assert abs(gm["loss"] - float(m["loss"])) <= 1e-5 * abs(
                float(m["loss"]))
        else:
            got = out["reshard"][(4, 1)]
        if cfg.moe is not None and k > 0:
            continue    # the loss only: see the docstring
        want = R.host(state)
        for part in ("mu", "nu"):
            leaves = T.leaves(getattr(want.opt, part))
            top = max(float(np.max(np.abs(b))) for b in leaves)
            for a, b in zip(T.leaves(getattr(got.opt, part)), leaves):
                _adamw_close(a, b, 1e-4 * top, f"{arch} step {k + 1} {part}")
        for a, b in zip(T.leaves(got.params), T.leaves(want.params)):
            _adamw_close(a, b, lr_sum, f"{arch} step {k + 1} params")


def test_lm_staged_collectives_on_card(cuda, tmp_path):
    """The staged backend on CUDA tensors: its Shard -> Shard kernel gives
    the whole tensor's chunk (and DTensor's move, which runs through it on
    a card), ``agree``, and the sharded loop's agreement and resume."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    import torch_lm_mesh_ranks as R

    from repro_torch.launch import ranks

    outs = ranks.spawn(R.misc, 4, (str(tmp_path), "cuda"), device="cuda",
                       timeout_s=120)
    for r, out in enumerate(outs):
        assert out["alltoall"], r
        assert out["agree"] == (3.0, 1.5), (r, out["agree"])
        assert out["agree_nan"], r
    reports = [o["report"] for o in outs]
    assert all(r == reports[0] for r in reports), reports
    assert reports[0][1] == [(1, "nan_loss")] and reports[0][3] == 3
    assert all(o["resumed_step"] == 3 for o in outs)
