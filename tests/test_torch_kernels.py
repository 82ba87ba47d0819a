"""The port's kernel entries against the reference's Pallas kernels.

The reference runs its Pallas kernels in interpret mode, as
tests/test_kernels.py runs them. The port's ``"cuda"`` backend on CPU
tensors takes each kernel's plain version (the CUDA kernels themselves run
only on the card: tests/test_torch_gpu.py), and ``"ref"`` is the port's
plain contract. All three must agree bit for bit.
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

# The SHAPES of tests/test_kernels.py: (C, J, L), with L = 31, 33 and 513.
SHAPES = [
    (1, 2, 5),
    (3, 16, 32),
    (2, 6, 17),
    (3, 8, 31),
    (3, 8, 33),
    (10, 100, 200),
    (4, 33, 129),
    (2, 6, 513),
]
BACKENDS = ["cuda", "ref"]
# The K1/K2/K8 cases (C, J, L, offset): SHAPES, then the widths at the CUDA
# kernels' path boundaries (the vector path takes L % 16 == 0 with
# 16-byte-aligned operands, the scalar path the rest: L = 1, 15, 16, 17 and
# 98, f = 49), then operands that are views with a storage offset of
# ``offset`` elements (:func:`_at`), which start off a 16-byte boundary.
KERNEL_SHAPES = ([(*s, 0) for s in SHAPES]
                 + [(2, 3, L, 0) for L in (1, 15, 16, 17, 98)]
                 + [(3, 16, 32, 1), (3, 8, 33, 33), (2, 5, 98, 3)])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _seed(*parts) -> int:
    return abs(hash(parts)) % 2**31


def _at(a, offset: int) -> torch.Tensor:
    """``a`` as a contiguous view ``offset`` elements into a larger
    tensor (row 1 of a [2, L] literal tensor is ``offset = L``)."""
    a = np.asarray(a)
    flat = torch.zeros(a.size + offset, dtype=_t(a).dtype)
    flat[offset:] = _t(a.ravel())
    return flat[offset:].view(a.shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_clause_eval_matches_pallas(shape, training):
    C, J, L = shape
    rng = np.random.default_rng(_seed(shape, "ce"))
    include = rng.random((C, J, L)) < 0.3
    lits = rng.random((L,)) < 0.5
    include[0, 0] = False                       # an empty clause
    want = np.asarray(j_ops.clause_eval(jnp.asarray(include),
                                        jnp.asarray(lits), training=training))
    for name in BACKENDS:
        got = dispatch.resolve(name).clause_eval(_t(include), _t(lits),
                                                 training=training)
        assert np.array_equal(want, got.numpy()), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("training", [True, False])
def test_clause_eval_batch_matches_pallas(shape, training):
    C, J, L = shape
    B = 7
    rng = np.random.default_rng(_seed(shape, "ceb"))
    include = rng.random((C, J, L)) < 0.1
    lits = rng.random((B, L)) < 0.7
    include[-1, -1] = False
    want = np.asarray(j_ops.clause_eval_batch(
        jnp.asarray(include), jnp.asarray(lits), training=training))
    for name in BACKENDS:
        got = dispatch.resolve(name).clause_eval_batch(
            _t(include), _t(lits), training=training)
        assert np.array_equal(want, got.numpy()), name


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_clause_counts_kernels_match_pallas(shape):
    """K1 and K2 themselves: the counts, not only the derived outputs."""
    C, J, L, off = shape
    rng = np.random.default_rng(_seed(shape, "cc"))
    inc = rng.random((C * J, L)) < 0.2
    lits = rng.random((5, L)) < 0.5
    v1, n1 = j_ce.clause_counts(jnp.asarray(inc), jnp.asarray(lits[0]))
    v2, n2 = t_ce.clause_counts(_at(inc, off), _at(lits[0], off))
    assert np.array_equal(np.asarray(v1), v2.numpy())
    assert np.array_equal(np.asarray(n1), n2.numpy())
    vb1, nb1 = j_ce.clause_counts_batch(jnp.asarray(inc), jnp.asarray(lits))
    vb2, nb2 = t_ce.clause_counts_batch(_at(inc, off), _at(lits, off))
    assert vb2.dtype == torch.int32 and nb2.dtype == torch.int32
    assert np.array_equal(np.asarray(vb1), vb2.numpy())
    assert np.array_equal(np.asarray(nb1), nb2.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("policy", ["standard", "hardware"])
@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_feedback_matches_pallas(shape, policy, dtype):
    C, J, L = shape
    n_states = 50 if dtype == "int8" else 5000
    rng = np.random.default_rng(_seed(shape, policy, dtype))
    ta = rng.integers(1, 2 * n_states + 1, (C, J, L)).astype(dtype)
    lits = rng.random((L,)) < 0.5
    c_out = rng.random((C, J)) < 0.5
    t1 = rng.random((C, J)) < 0.5
    t2 = (rng.random((C, J)) < 0.3) & ~t1
    u = rng.random((C, J, L)).astype(np.float32)
    for boost in (True, False):
        kw = dict(n_states=n_states, s_policy=policy,
                  boost_true_positive=boost)
        want = np.asarray(j_ops.feedback_step(
            *map(jnp.asarray, (ta, lits, c_out, t1, t2, u)),
            s=jnp.float32(1.375), **kw))
        for name in BACKENDS:
            got = dispatch.resolve(name).feedback_step(
                *map(_t, (ta, lits, c_out, t1, t2, u)),
                s=torch.tensor(1.375), **kw)
            assert got.dtype == getattr(torch, dtype)
            assert np.array_equal(want, got.numpy()), (name, boost)


# The K8 cases (C, J, L, TA type, offset): int8 and int16 banks at the
# widths of KERNEL_SHAPES' boundaries and as views with a storage offset.
FEEDBACK_SHAPES = (
    [(3, 16, 32, "int8", 0), (2, 6, 513, "int8", 0),
     (3, 16, 32, "int16", 0), (2, 6, 513, "int16", 0)]
    + [(2, 3, L, dt, 0) for L in (1, 15, 16, 17, 98)
       for dt in ("int8", "int16")]
    + [(3, 16, 32, dt, off) for dt in ("int8", "int16") for off in (1, 32)]
    + [(3, 8, 33, "int8", 33), (2, 5, 98, "int16", 3)])


@pytest.mark.parametrize("shape", FEEDBACK_SHAPES)
def test_feedback_plane_kernel_matches_pallas(shape):
    """K8 itself, on the flattened plane with explicit probabilities."""
    C, J, L, dtype, off = shape
    n_states = 16 if dtype == "int8" else 5000
    rng = np.random.default_rng(_seed(shape, "fp"))
    ta = rng.integers(1, 2 * n_states + 1, (C * J, L)).astype(dtype)
    lits = rng.random((L,)) < 0.5
    ctl = [rng.random((C * J,)) < 0.5 for _ in range(3)]
    u = rng.random((C * J, L)).astype(np.float32)
    ps, pe = np.float32(0.6), np.float32(0.3)
    want = j_fb.feedback_plane(*map(jnp.asarray, (ta, lits, *ctl, u)),
                               jnp.float32(ps), jnp.float32(pe),
                               n_states=n_states)
    got = t_fb.feedback_plane(*(_at(a, off) for a in (ta, lits, *ctl, u)),
                              float(ps), float(pe), n_states=n_states)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("kind", ["uint8", "int8"])
@pytest.mark.parametrize("L", [17, 32])
def test_byte_valued_batch_counts_match_pallas_on_bools(kind, L):
    """K2, K4 and K7 on bytes count any nonzero byte as 1: the wrappers
    take uint8 and int8 views, and the CUDA body normalises them. On CPU
    tensors their plain versions, given set bytes of 1, 2 and 255 (uint8)
    or 1, 2 and -1 (int8), equal the reference's Pallas kernels on the
    same operands as bools."""
    rng = np.random.default_rng(_seed(kind, L, "bytes"))
    R, D, C, J, M, B = 4, 2, 3, 8, 5, 6
    vals = (1, 2, 255) if kind == "uint8" else (1, 2, -1)

    def plane(shape, p):
        bits = rng.random(shape) < p
        return bits, _t(np.where(bits, rng.choice(vals, size=shape),
                                 0).astype(kind))

    inc_b, inc = plane((R, C * J, L), 0.2)
    lit_b, lit = plane((D, B, L), 0.5)
    for want, got in (
            (j_ce.clause_counts_batch(jnp.asarray(inc_b[0]),
                                      jnp.asarray(lit_b[0])),
             t_ce.clause_counts_batch(inc[0], lit[0])),
            (j_ce.clause_counts_batch_replicated(jnp.asarray(inc_b),
                                                 jnp.asarray(lit_b)),
             t_ce.clause_counts_batch_replicated(inc, lit))):
        assert all(np.array_equal(np.asarray(w), g.numpy())
                   for w, g in zip(want, got))
    sel = rng.integers(0, J, (R, C, M))
    gathered = np.take_along_axis(inc_b.reshape(R, C, J, L),
                                  sel[..., None], axis=2)
    want = j_ce.clause_counts_batch_replicated(
        jnp.asarray(gathered.reshape(R, C * M, L)), jnp.asarray(lit_b))
    got = t_ce.clause_counts_batch_pruned_replicated(
        inc.reshape(R, C, J, L), _t(sel.astype(np.int32)), lit)
    assert all(np.array_equal(np.asarray(w), g.numpy())
               for w, g in zip(want, got))
    got1 = t_ce.clause_counts_batch_pruned(inc[0].reshape(C, J, L),
                                           _t(sel[0]), lit[0])
    assert all(np.array_equal(np.asarray(w)[0], g.numpy())
               for w, g in zip(want, got1))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    """A CPU tensor never launches a kernel, so no launch is counted."""
    before = (t_ce.clause_counts.launches, t_ce.clause_counts_batch.launches,
              t_fb.feedback_plane.launches)
    inc = torch.zeros(4, 8, dtype=torch.bool)
    t_ce.clause_counts(inc, torch.ones(8, dtype=torch.bool))
    t_ce.clause_counts_batch(inc, torch.ones(2, 8, dtype=torch.bool))
    t_fb.feedback_plane(torch.ones(4, 8, dtype=torch.int8),
                        torch.ones(8, dtype=torch.bool),
                        *(torch.ones(4, dtype=torch.bool),) * 3,
                        torch.zeros(4, 8), 1.0, 0.5, n_states=4)
    after = (t_ce.clause_counts.launches, t_ce.clause_counts_batch.launches,
             t_fb.feedback_plane.launches)
    assert before == after


def test_auto_resolves_to_cuda_with_override(monkeypatch):
    monkeypatch.delenv("TM_BACKEND", raising=False)
    assert dispatch.resolve("auto").name == "cuda"
    monkeypatch.setenv("TM_BACKEND", "ref")
    assert dispatch.resolve("auto").name == "ref"
    with pytest.raises(ValueError):
        dispatch.resolve("pallas")
