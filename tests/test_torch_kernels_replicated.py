"""The port's replica-first kernel entries against the reference's Pallas
kernels K3, K4 and K9.

The reference runs its Pallas kernels in interpret mode, as
tests/test_kernels.py runs them. The port's ``"cuda"`` backend on CPU
tensors takes each kernel's plain version (the CUDA kernels themselves run
only on the card: tests/test_torch_gpu.py), and ``"ref"`` is the port's
plain contract. All must agree bit for bit, over tests/test_kernels.py's
REP_SHAPES (R, D, C, J, L), which include D < R (a grid over one data
stream) so a wrong replica-to-stream map cannot pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import clause_eval as j_ce
from repro.kernels import feedback as j_fb
from repro.kernels import ops as j_ops
from repro_torch.kernels import clause_eval as t_ce
from repro_torch.kernels import dispatch
from repro_torch.kernels import feedback as t_fb

REP_SHAPES = [
    (1, 1, 1, 2, 5),
    (3, 1, 2, 6, 17),
    (6, 3, 3, 16, 32),
    (2, 2, 2, 8, 31),
    (5, 5, 2, 7, 33),
    (4, 2, 4, 33, 129),
    (4, 2, 2, 6, 513),
]
BACKENDS = ["cuda", "ref"]
# The K3/K4/K9 cases (R, D, C, J, L, offset): REP_SHAPES, then the widths
# at the CUDA kernels' path boundaries (the vector path takes L % 16 == 0
# with 16-byte-aligned operands, the scalar path the rest), all with
# D < R, then operands that are views with a storage offset of ``offset``
# elements (:func:`_at`), which start off a 16-byte boundary.
KERNEL_SHAPES = ([(*s, 0) for s in REP_SHAPES]
                 + [(4, 2, 2, 3, L, 0) for L in (1, 15, 16, 17, 98)]
                 + [(6, 3, 3, 16, 32, 1), (3, 1, 2, 6, 33, 33),
                    (4, 2, 2, 5, 98, 3)])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rng(shape, tag) -> np.random.Generator:
    return np.random.default_rng([*shape, tag])


def _at(a, offset: int) -> torch.Tensor:
    """``a`` as a contiguous view ``offset`` elements into a larger
    tensor (row 1 of a [2, L] literal tensor is ``offset = L``)."""
    a = np.asarray(a)
    flat = torch.zeros(a.size + offset, dtype=_t(a).dtype)
    flat[offset:] = _t(a.ravel())
    return flat[offset:].view(a.shape)


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_clause_eval_replicated_matches_pallas(shape, training):
    R, D, C, J, L = shape
    rng = _rng(shape, 1)
    include = rng.random((R, C, J, L)) < 0.3
    include[0, 0, 0] = False                    # an empty clause
    lits = rng.random((D, L)) < 0.5
    want = np.asarray(j_ops.clause_eval_replicated(
        jnp.asarray(include), jnp.asarray(lits), training=training))
    for name in BACKENDS:
        got = dispatch.resolve(name).clause_eval_replicated(
            _t(include), _t(lits), training=training)
        assert np.array_equal(want, got.numpy()), name


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_clause_eval_batch_replicated_matches_pallas(shape, training):
    R, D, C, J, L = shape
    rng = _rng(shape, 2)
    include = rng.random((R, C, J, L)) < 0.1
    include[-1, -1, -1] = False
    lits = rng.random((D, 5, L)) < 0.7
    want = np.asarray(j_ops.clause_eval_batch_replicated(
        jnp.asarray(include), jnp.asarray(lits), training=training))
    for name in BACKENDS:
        got = dispatch.resolve(name).clause_eval_batch_replicated(
            _t(include), _t(lits), training=training)
        assert np.array_equal(want, got.numpy()), name


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_replicated_count_kernels_match_pallas(shape):
    """K3 and K4 themselves: the counts, not only the derived outputs."""
    R, D, C, J, L, off = shape
    rng = _rng(shape[:5], 3)
    inc = rng.random((R, C * J, L)) < 0.2
    lits = rng.random((D, 7, L)) < 0.5
    want = j_ce.clause_counts_replicated(jnp.asarray(inc),
                                         jnp.asarray(lits[:, 0]))
    got = t_ce.clause_counts_replicated(_at(inc, off), _at(lits[:, 0], off))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())
    want = j_ce.clause_counts_batch_replicated(jnp.asarray(inc),
                                               jnp.asarray(lits))
    got = t_ce.clause_counts_batch_replicated(_at(inc, off), _at(lits, off))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy())


def _feedback_inputs(shape, dtype, n_states, tag):
    R, D, C, J, L = shape
    rng = _rng(shape, tag)
    return dict(
        ta=rng.integers(1, 2 * n_states + 1, (R, C, J, L)).astype(dtype),
        lits=rng.random((D, L)) < 0.5,
        c_out=rng.random((R, C, J)) < 0.5,
        t1=(t1 := rng.random((R, C, J)) < 0.5),
        t2=(rng.random((R, C, J)) < 0.3) & ~t1,
        u=rng.random((D, C, J, L), dtype=np.float32),
        s=(1.0 + 5.0 * rng.random(R)).astype(np.float32),
    )


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("policy", ["standard", "hardware"])
@pytest.mark.parametrize("dtype,n_states", [(np.int8, 50), (np.int16, 5000)])
def test_feedback_step_replicated_matches_pallas(shape, policy, dtype,
                                                 n_states):
    a = _feedback_inputs(shape, dtype, n_states, 4)
    ops = ("ta", "lits", "c_out", "t1", "t2", "u")
    for boost in (True, False):
        kw = dict(n_states=n_states, s_policy=policy,
                  boost_true_positive=boost)
        want = np.asarray(j_ops.feedback_step_replicated(
            *(jnp.asarray(a[k]) for k in ops), s=jnp.asarray(a["s"]), **kw))
        for name in BACKENDS:
            got = dispatch.resolve(name).feedback_step_replicated(
                *(_t(a[k]) for k in ops), s=_t(a["s"]), **kw)
            assert got.dtype == _t(a["ta"]).dtype
            assert np.array_equal(want, got.numpy()), (name, boost)


# The K9 cases (R, D, C, J, L, TA type, offset): int8 banks at REP_SHAPES,
# then int8 and int16 at the path-boundary widths (D < R) and as views
# with a storage offset.
FEEDBACK_SHAPES = (
    [(*s, np.int8, 0) for s in REP_SHAPES]
    + [(6, 3, 3, 16, 32, np.int16, 0), (4, 2, 2, 6, 513, np.int16, 0)]
    + [(4, 2, 2, 3, L, dt, 0) for L in (1, 15, 16, 17, 98)
       for dt in (np.int8, np.int16)]
    + [(6, 3, 3, 16, 32, dt, off) for dt in (np.int8, np.int16)
       for off in (1, 32)]
    + [(3, 1, 2, 6, 33, np.int8, 33), (4, 2, 2, 5, 98, np.int16, 3)])


@pytest.mark.parametrize("shape", FEEDBACK_SHAPES)
def test_feedback_plane_replicated_matches_pallas(shape):
    """K9 itself over the flattened planes, with per-replica p."""
    R, D, C, J, L, dtype, off = shape
    n_states = 63 if dtype == np.int8 else 5000
    a = _feedback_inputs(shape[:5], dtype, n_states, 5)
    rng = _rng(shape[:5], 6)
    ps = rng.random(R).astype(np.float32)
    pe = rng.random(R).astype(np.float32)
    args = (a["ta"].reshape(R, C * J, L), a["lits"],
            a["c_out"].reshape(R, -1), a["t1"].reshape(R, -1),
            a["t2"].reshape(R, -1), a["u"].reshape(D, C * J, L), ps, pe)
    want = np.asarray(j_fb.feedback_plane_replicated(
        *(jnp.asarray(x) for x in args), n_states=n_states))
    got = t_fb.feedback_plane_replicated(*(_at(x, off) for x in args),
                                         n_states=n_states)
    assert got.dtype == _t(a["ta"]).dtype
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("shape", [s for s in REP_SHAPES if s[0] > s[1]])
@pytest.mark.parametrize("name", BACKENDS)
def test_stacking_rule(shape, name):
    """Replica r equals the single-bank entry on data row r % D (D < R, so
    a block layout r // H would fail)."""
    R, D, C, J, L = shape
    be = dispatch.resolve(name)
    a = {k: _t(v) for k, v in _feedback_inputs(shape, np.int8, 50, 7).items()}
    inc = a["ta"] > 50
    batch = torch.from_numpy(_rng(shape, 8).random((D, 3, L)) < 0.5)
    one = be.clause_eval_replicated(inc, a["lits"], training=True)
    many = be.clause_eval_batch_replicated(inc, batch, training=False)
    fb = be.feedback_step_replicated(
        a["ta"], a["lits"], a["c_out"], a["t1"], a["t2"], a["u"], s=a["s"],
        n_states=50, s_policy="standard", boost_true_positive=False)
    for r in range(R):
        d = r % D
        assert torch.equal(one[r], be.clause_eval(inc[r], a["lits"][d],
                                                  training=True))
        assert torch.equal(many[r], be.clause_eval_batch(inc[r], batch[d],
                                                         training=False))
        assert torch.equal(fb[r], be.feedback_step(
            a["ta"][r], a["lits"][d], a["c_out"][r], a["t1"][r], a["t2"][r],
            a["u"][d], s=a["s"][r], n_states=50, s_policy="standard",
            boost_true_positive=False))


def test_replicated_entries_reject_bad_data_axis():
    inc = torch.zeros((4, 2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="must divide"):
        t_ce.clause_counts_replicated(inc, torch.zeros((3, 8), dtype=bool))
    with pytest.raises(ValueError, match="must divide"):
        t_ce.clause_counts_batch_replicated(
            inc, torch.zeros((3, 2, 8), dtype=bool))
    with pytest.raises(ValueError, match="must divide"):
        t_fb.feedback_plane_replicated(
            torch.ones((4, 2, 8), dtype=torch.int8),
            torch.zeros((3, 8), dtype=bool), *([torch.zeros((4, 2),
                                                            dtype=bool)] * 3),
            torch.zeros((3, 2, 8)), torch.ones(4), torch.ones(4), n_states=3)
