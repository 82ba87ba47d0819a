"""The port's twin of ``tests/test_properties.py``: the same eight
``hypothesis`` properties at the reference's ``max_examples``, on the
port (its kernel entries run their plain versions on CPU tensors), each
also held bit for bit to the reference on the same drawn inputs: the
kernels against their oracles, train-step bounds, stuck-at clauses, the
ring buffer as a bounded FIFO, block orderings, and replicated feedback.
"""
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="optional dev dependency (requirements-dev.txt)"
)
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import tm as j_tm  # noqa: E402
from repro.core.feedback import train_step as j_train_step  # noqa: E402
from repro.data import blocks as j_blocks  # noqa: E402
from repro.data import buffer as j_buffer  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import tm as p_tm  # noqa: E402
from repro_torch.core.feedback import train_step as p_train_step  # noqa: E402
from repro_torch.data import blocks as p_blocks  # noqa: E402
from repro_torch.data import buffer as p_buffer  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serve.router import _enqueue_rows  # noqa: E402

_shapes = st.tuples(
    st.integers(1, 4),    # classes
    st.integers(1, 10).map(lambda j: 2 * j),  # clauses (even)
    st.integers(1, 40),   # literals
)


# the reference's functions, jitted once (a new shape still compiles, but
# as one program: eager JAX dispatches and compiles every op anew)
_j_clause_eval = jax.jit(j_ref.clause_eval, static_argnames=("training",))
_FB_STATIC = ("n_states", "s_policy", "boost_true_positive")
_j_feedback = jax.jit(j_ref.feedback_step, static_argnames=_FB_STATIC)
_j_feedback_rep = jax.jit(j_ref.feedback_step_replicated,
                          static_argnames=_FB_STATIC)
_j_train_step = jax.jit(j_train_step, static_argnums=(0,))
_j_push = jax.jit(j_buffer.push)
_j_pop = jax.jit(j_buffer.pop)


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, convert.key_from_numpy(np.asarray(k), "cpu")


@settings(max_examples=25, deadline=None)
@given(shape=_shapes, seed=st.integers(0, 2**31 - 1), training=st.booleans())
def test_kernel_clause_eval_equals_oracle(shape, seed, training):
    C, J, L = shape
    rng = np.random.default_rng(seed)
    include = rng.random((C, J, L)) < rng.random()
    lits = rng.random((L,)) < 0.5
    got = ops.clause_eval(torch.from_numpy(include), torch.from_numpy(lits),
                          training=training)
    want = ref.clause_eval(torch.from_numpy(include), torch.from_numpy(lits),
                           training=training)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), np.asarray(_j_clause_eval(
        jnp.asarray(include), jnp.asarray(lits), training=training)))


@settings(max_examples=25, deadline=None)
@given(
    shape=_shapes,
    seed=st.integers(0, 2**31 - 1),
    s=st.floats(1.0, 10.0),
    policy=st.sampled_from(["standard", "hardware"]),
)
def test_kernel_feedback_equals_oracle_and_bounds(shape, seed, s, policy):
    C, J, L = shape
    n = 50
    rng = np.random.default_rng(seed)
    ta = rng.integers(1, 2 * n + 1, (C, J, L)).astype(np.int8)
    lits = rng.random((L,)) < 0.5
    c_out = rng.random((C, J)) < 0.5
    t1 = rng.random((C, J)) < 0.5
    t2 = (rng.random((C, J)) < 0.5) & ~t1
    u = rng.random((C, J, L)).astype(np.float32)
    kw = dict(n_states=n, s_policy=policy,
              boost_true_positive=bool(seed % 2))
    args = [torch.from_numpy(a) for a in (ta, lits, c_out, t1, t2, u)]
    s32 = torch.tensor(s, dtype=torch.float32)
    want = ref.feedback_step(*args, s=s32, **kw).numpy()
    got = ops.feedback_step(*args, s=s32, **kw).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(got, np.asarray(_j_feedback(
        *(jnp.asarray(a) for a in (ta, lits, c_out, t1, t2, u)),
        s=jnp.float32(s), **kw)))
    # invariants: states in [1, 2N]; |delta| <= 1 per TA per step
    assert want.min() >= 1 and want.max() <= 2 * n
    assert np.abs(want.astype(int) - ta.astype(int)).max() <= 1


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_train_step_invariants(seed):
    """After any train step: state bounds hold; votes bounded by the
    clause count; the step equals the reference's."""
    kw = dict(n_features=8, max_classes=3, max_clauses=8, n_states=20)
    jc, pc = j_tm.TMConfig(**kw), p_tm.TMConfig(backend="cuda", **kw)
    rng = np.random.default_rng(seed)
    jk0, pk0 = _key(seed % 997)
    st0 = p_tm.init_state(pc, pk0, device="cpu")
    s, T = 1.0 + 5 * rng.random(), int(rng.integers(1, 20))
    rt = p_tm.init_runtime(pc, s=s, T=T, device="cpu")
    x = rng.random(8) < 0.5
    y = np.int32(rng.integers(0, 3))
    jk, pk = _key(seed % 991)
    st1, aux = p_train_step(pc, st0, rt, torch.from_numpy(x),
                            torch.tensor(y), pk)
    v = st1.ta_state.numpy()
    assert v.min() >= 1 and v.max() <= 2 * pc.n_states
    assert int(aux.votes.abs().max()) <= pc.max_clauses // 2
    assert 0.0 <= float(aux.activity) <= 1.0
    jst1, jaux = _j_train_step(jc, j_tm.init_state(jc, jk0),
                              j_tm.init_runtime(jc, s=s, T=T),
                              jnp.asarray(x), jnp.int32(y), jk)
    assert np.array_equal(v, np.asarray(jst1.ta_state))
    assert np.array_equal(aux.votes.numpy(), np.asarray(jaux.votes))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), frac=st.floats(0.05, 0.5))
def test_fault_masks_force_clause_eval(seed, frac):
    """Stuck-at-0 on every TA of a clause makes it empty whatever the
    state."""
    pc = p_tm.TMConfig(n_features=8, max_classes=2, max_clauses=4,
                       n_states=20)
    _, pk = _key(seed % 1013)
    st0 = p_tm.init_state(pc, pk, device="cpu")
    rt = p_tm.init_runtime(pc, device="cpu")
    and_m = np.ones((2, 4, 16), dtype=bool)
    and_m[0, 0, :] = False  # every TA of clause (0, 0)
    rt = p_faults.inject(rt, and_m, np.zeros_like(and_m))
    acts = p_tm.ta_actions(pc, st0, rt)
    assert not bool(acts[0, 0].any())
    x = torch.from_numpy(np.random.default_rng(seed).random(8) < 0.5)
    cl = p_tm.eval_clauses(pc, acts, p_tm.make_literals(x), rt,
                           training=False)
    assert not bool(cl[0, 0])  # an empty clause at inference votes 0


def _push(buf, x, y):
    """One row into one ring, through the router's enqueue (a plane of
    one ring)."""
    rings, acc = _enqueue_rows(p_buffer.stack(buf, 1), x[None, None],
                               np.asarray([[y]], np.int32), np.ones(1))
    return p_buffer.RingBuffer(*(a[0] for a in rings)), bool(acc[0])


def _same_ring(p, j):
    for a, b in zip(p, j):
        assert np.array_equal(a.numpy(), np.asarray(b))


@settings(max_examples=10, deadline=None)
@given(
    cap=st.integers(1, 8),
    ops_seq=st.lists(st.tuples(st.booleans(), st.integers(0, 99)), max_size=30),
)
def test_ring_buffer_model(cap, ops_seq):
    """The ring behaves exactly like a bounded FIFO (model-based), and
    like the reference's ring after every operation."""
    buf, jbuf = p_buffer.make(cap, 2, "cpu"), j_buffer.make(cap, 2)
    model: deque = deque()
    for is_push, val in ops_seq:
        if is_push:
            row = np.asarray([val % 2, 1], dtype=bool)
            buf, ok = _push(buf, row, val)
            jbuf, jok = _j_push(jbuf, jnp.asarray(row), jnp.int32(val))
            assert ok == bool(jok) == (len(model) < cap)
            if len(model) < cap:
                model.append(val)
        else:
            buf, x, y, valid = p_buffer.pop(buf)
            jbuf, _, jy, jvalid = _j_pop(jbuf)
            assert bool(valid) == bool(jvalid) == (len(model) > 0)
            if model:
                assert int(y) == int(jy) == model.popleft()
        assert int(buf.size) == len(model)
        _same_ring(buf, jbuf)


@settings(max_examples=20, deadline=None)
@given(
    cap=st.integers(1, 10),
    vals=st.lists(st.integers(0, 999), min_size=0, max_size=40),
    extra_pops=st.integers(0, 5),
)
def test_ring_buffer_fifo_capacity_and_empty_pop(cap, vals, extra_pops):
    """FIFO order kept, size never past capacity, a pop on an empty ring
    flagged and changing nothing."""
    buf = p_buffer.make(cap, 3, "cpu")
    accepted = []
    for v in vals:
        buf, ok = _push(buf, np.asarray([v % 2, (v >> 1) % 2, 1], bool), v)
        if ok:
            accepted.append(v)
        assert 0 <= int(buf.size) <= cap
    popped = []
    for _ in range(len(accepted) + extra_pops):
        before = [a.clone() for a in buf]
        buf, x, y, nonempty = p_buffer.pop(buf)
        if bool(nonempty):
            popped.append(int(y))
        else:
            for a, b in zip(before, buf):
                assert torch.equal(a, b)
    assert popped == accepted
    assert int(buf.size) == 0


@settings(max_examples=15, deadline=None)
@given(
    block_len=st.integers(1, 8),
    blocks_split=st.tuples(
        st.integers(1, 3), st.integers(1, 3), st.integers(1, 3)
    ),
    n_orderings=st.integers(1, 12),
    seed=st.integers(0, 2**31 - 1),
)
def test_block_orderings_partition_dataset(
    block_len, blocks_split, n_orderings, seed
):
    """Every ordering partitions the dataset exactly; set sizes match
    ``BlockSpec.sizes()``; orderings and sets equal the reference's."""
    a, b, c = blocks_split
    spec = p_blocks.BlockSpec(block_len=block_len, offline_blocks=a,
                              validation_blocks=b, online_blocks=c)
    n = spec.n_blocks * block_len
    rng = np.random.default_rng(seed)
    xs = rng.random((n, 4)) < 0.5
    ys = np.arange(n, dtype=np.int32)
    orderings = p_blocks.select_orderings(spec.n_blocks, n_orderings,
                                          seed=seed)
    sets = p_blocks.make_sets(xs, ys, spec, orderings)
    assert np.array_equal(orderings, j_blocks.select_orderings(
        spec.n_blocks, n_orderings, seed=seed))
    jsets = j_blocks.make_sets(xs, ys, j_blocks.BlockSpec(
        block_len=block_len, offline_blocks=a, validation_blocks=b,
        online_blocks=c), orderings)
    for got, want in zip(sets, jsets):
        assert np.array_equal(got, want)
    assert sets.offline_y.shape[1:] == (spec.sizes()[0],)
    assert sets.validation_y.shape[1:] == (spec.sizes()[1],)
    assert sets.online_y.shape[1:] == (spec.sizes()[2],)
    for o in range(len(orderings)):
        labels = np.concatenate(
            [sets.offline_y[o], sets.validation_y[o], sets.online_y[o]])
        np.testing.assert_array_equal(np.sort(labels), ys)
        rows = np.concatenate(
            [sets.offline_x[o], sets.validation_x[o], sets.online_x[o]])
        np.testing.assert_array_equal(rows[np.argsort(labels)], xs)


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    shape=st.tuples(
        st.integers(1, 3),                        # H (grid cells per stream)
        st.integers(1, 3),                        # D (data streams)
        st.integers(1, 3),                        # classes
        st.integers(1, 6).map(lambda j: 2 * j),   # clauses (even)
        st.integers(1, 40),                       # literals
    ),
    policy=st.sampled_from(["standard", "hardware"]),
)
def test_kernel_feedback_replicated_equals_stacked_oracle(seed, shape, policy):
    """For any R = H * D layout, replicated feedback equals the stacked
    per-replica feedback bitwise, on the port's ref and its kernel
    entry, and the reference's replicated oracle."""
    H, D, C, J, L = shape
    R = H * D
    n = 50
    rng = np.random.default_rng(seed)
    ta = rng.integers(1, 2 * n + 1, (R, C, J, L)).astype(np.int8)
    lits = rng.random((D, L)) < 0.5
    c_out = rng.random((R, C, J)) < 0.5
    t1 = rng.random((R, C, J)) < 0.5
    t2 = (rng.random((R, C, J)) < 0.5) & ~t1
    u = rng.random((D, C, J, L)).astype(np.float32)
    s = (1.0 + 5.0 * rng.random(R)).astype(np.float32)
    kw = dict(n_states=n, s_policy=policy, boost_true_positive=bool(seed % 2))
    T = [torch.from_numpy(a) for a in (ta, lits, c_out, t1, t2, u)]
    want = np.stack([
        ref.feedback_step(T[0][r], T[1][r % D], T[2][r], T[3][r], T[4][r],
                          T[5][r % D], s=torch.tensor(s[r]), **kw).numpy()
        for r in range(R)])
    for mod in (ref, ops):
        got = mod.feedback_step_replicated(*T, s=torch.from_numpy(s),
                                           **kw).numpy()
        np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(want, np.asarray(
        _j_feedback_rep(
            *(jnp.asarray(a) for a in (ta, lits, c_out, t1, t2, u)),
            s=jnp.asarray(s), **kw)))
    assert want.min() >= 1 and want.max() <= 2 * n
    assert np.abs(want.astype(int) - ta.astype(int)).max() <= 1
