"""The port's pruned (budgeted) entries, K7, against the JAX package.

``clause_eval_batch_pruned{,_replicated,_packed,_replicated_packed}`` on
both port backends (on CPU tensors ``"cuda"`` runs each kernel's plain
version: the gather, then the plain K2/K4/K5/K6 counts; the CUDA kernel
itself runs on the card, tests/test_torch_gpu.py) against
``repro.kernels.ref`` and ``repro.kernels.ops`` (the Pallas kernels in
interpret mode), bit for bit, over tests/test_kernels.py's SHAPES and
REP_SHAPES, with M in {1, J - 1, J} and selections that are permutation
prefixes or arbitrary ids with repeats. Packed pruned equals unpacked
pruned; the budgeted votes (dtype included) and ``analyze_pruned`` equal
the JAX functions'. K7's word counts also equal the Pallas
``clause_counts_batch{,_replicated}_packed`` on the gathered bank at the
word widths on the CUDA word body's edges (W = 1 to 700), on three kinds
of words, with int16, uint8, int32 and int64 selections holding ids 0
and J - 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JConfig
from repro.core import accuracy as j_acc
from repro.core import init_runtime as j_init_runtime
from repro.core import tm as j_tm
from repro.kernels import clause_eval as j_ce
from repro.kernels import ops as j_ops
from repro.kernels import packing as j_packing
from repro.kernels import ref as j_ref
from repro_torch import convert
from repro_torch.core import TMConfig as TConfig
from repro_torch.core import accuracy as t_acc
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import tm as t_tm
from repro_torch.kernels import clause_eval as t_ce
from repro_torch.kernels import dispatch
from repro_torch.kernels import packing as t_packing
from repro_torch.kernels import ref as t_ref

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
REP_SHAPES = [
    (1, 1, 1, 2, 5),
    (3, 1, 2, 6, 17),
    (6, 3, 3, 16, 32),
    (2, 2, 2, 8, 31),
    (5, 5, 2, 7, 33),
    (4, 2, 4, 33, 129),
    (4, 2, 2, 6, 513),
]
M_KINDS = ["one", "all_but_one", "all"]
BACKENDS = ["cuda", "ref"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _m(kind: str, J: int) -> int:
    return {"one": 1, "all_but_one": max(1, J - 1), "all": J}[kind]


def _sels(rng, lead: tuple, J: int, M: int):
    """Two selections [*lead, M] int32: a permutation prefix per row, and
    arbitrary ids with repeats (every id in [0, J))."""
    rows = int(np.prod(lead)) if lead else 1
    perm = np.stack([rng.permutation(J)[:M] for _ in range(rows)])
    rep = rng.integers(0, J, (rows, M))
    rep[:, -1] = rep[:, 0]                      # a repeat in every row
    return [a.reshape(lead + (M,)).astype(np.int32) for a in (perm, rep)]


def _bank(rng, shape, p):
    inc = rng.random(shape) < p
    inc[..., 0, 0, :] = False                   # an empty clause
    inc[..., -1, -1, :] = True                  # an all-include clause
    return inc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mk", M_KINDS)
def test_clause_eval_batch_pruned_matches_reference(shape, mk):
    C, J, L = shape
    rng = np.random.default_rng([*shape, len(mk)])
    include = _bank(rng, (C, J, L), 0.1)
    lits = rng.random((6, L)) < 0.7
    M = _m(mk, J)
    for sel in _sels(rng, (C,), J, M):
        for training in (True, False):
            args = (jnp.asarray(include), jnp.asarray(sel), jnp.asarray(lits))
            want = np.asarray(j_ref.clause_eval_batch_pruned(
                *args, training=training))
            assert want.shape == (6, C, M)
            if training:
                pallas = np.asarray(j_ops.clause_eval_batch_pruned(
                    *args, training=training))
                assert np.array_equal(want, pallas)
            for name in BACKENDS:
                got = dispatch.resolve(name).clause_eval_batch_pruned(
                    _t(include), _t(sel), _t(lits), training=training)
                assert got.dtype == torch.bool
                assert np.array_equal(want, got.numpy()), (name, training)


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("mk", M_KINDS)
def test_clause_eval_batch_pruned_replicated_matches_reference(shape, mk):
    R, D, C, J, L = shape
    rng = np.random.default_rng([*shape, 7, len(mk)])
    include = _bank(rng, (R, C, J, L), 0.1)
    lits = rng.random((D, 5, L)) < 0.7
    M = _m(mk, J)
    for sel in _sels(rng, (R, C), J, M):
        for training in (True, False):
            args = (jnp.asarray(include), jnp.asarray(sel), jnp.asarray(lits))
            want = np.asarray(j_ref.clause_eval_batch_pruned_replicated(
                *args, training=training))
            assert want.shape == (R, 5, C, M)
            if training:
                pallas = np.asarray(j_ops.clause_eval_batch_pruned_replicated(
                    *args, training=training))
                assert np.array_equal(want, pallas)
            for name in BACKENDS:
                got = dispatch.resolve(
                    name).clause_eval_batch_pruned_replicated(
                    _t(include), _t(sel), _t(lits), training=training)
                assert np.array_equal(want, got.numpy()), (name, training)


def _packed_operands(rng, lead_i, lead_l, C, J, f, B):
    inc = _bank(rng, lead_i + (C, J, 2 * f), 0.1)
    x = rng.random(lead_l + (B, f)) < 0.5
    inc_w = np.asarray(j_packing.pack_include(jnp.asarray(inc), f))
    lit_w = np.asarray(j_packing.pack_literals(jnp.asarray(x)))
    return inc, np.concatenate([x, ~x], -1), inc_w, lit_w


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mk", M_KINDS)
def test_clause_eval_batch_pruned_packed_matches_reference(shape, mk):
    """The packed entry against the reference's ref and Pallas packed
    entries, and against the unpacked pruned entry (packed == unpacked)."""
    C, J, L = shape
    f = max(1, L // 2)
    rng = np.random.default_rng([*shape, 11, len(mk)])
    inc, lits, inc_w, lit_w = _packed_operands(rng, (), (), C, J, f, 6)
    M = _m(mk, J)
    for sel in _sels(rng, (C,), J, M):
        for training in (True, False):
            args = (jnp.asarray(inc_w), jnp.asarray(sel), jnp.asarray(lit_w))
            want = np.asarray(j_ref.clause_eval_batch_pruned_packed(
                *args, training=training))
            unpacked = np.asarray(j_ref.clause_eval_batch_pruned(
                jnp.asarray(inc), jnp.asarray(sel), jnp.asarray(lits),
                training=training))
            assert np.array_equal(want, unpacked)
            if training:
                pallas = np.asarray(j_ops.clause_eval_batch_pruned_packed(
                    *args, training=training))
                assert np.array_equal(want, pallas)
            for name in BACKENDS:
                kb = dispatch.resolve(name)
                got = kb.clause_eval_batch_pruned_packed(
                    t_packing.words_from_numpy(inc_w), _t(sel),
                    t_packing.words_from_numpy(lit_w), training=training)
                assert np.array_equal(want, got.numpy()), (name, training)
                got_u = kb.clause_eval_batch_pruned(
                    _t(inc), _t(sel), _t(lits), training=training)
                assert torch.equal(got, got_u), name


@pytest.mark.parametrize("shape", REP_SHAPES)
@pytest.mark.parametrize("mk", M_KINDS)
def test_clause_eval_batch_pruned_replicated_packed_matches_reference(
        shape, mk):
    R, D, C, J, L = shape
    f = max(1, L // 2)
    rng = np.random.default_rng([*shape, 13, len(mk)])
    inc, lits, inc_w, lit_w = _packed_operands(rng, (R,), (D,), C, J, f, 5)
    M = _m(mk, J)
    for sel in _sels(rng, (R, C), J, M):
        for training in (True, False):
            args = (jnp.asarray(inc_w), jnp.asarray(sel), jnp.asarray(lit_w))
            want = np.asarray(
                j_ref.clause_eval_batch_pruned_replicated_packed(
                    *args, training=training))
            if training:
                pallas = np.asarray(
                    j_ops.clause_eval_batch_pruned_replicated_packed(
                        *args, training=training))
                assert np.array_equal(want, pallas)
            for name in BACKENDS:
                kb = dispatch.resolve(name)
                got = kb.clause_eval_batch_pruned_replicated_packed(
                    t_packing.words_from_numpy(inc_w), _t(sel),
                    t_packing.words_from_numpy(lit_w), training=training)
                assert np.array_equal(want, got.numpy()), (name, training)
                got_u = kb.clause_eval_batch_pruned_replicated(
                    _t(inc), _t(sel), _t(lits), training=training)
                assert torch.equal(got, got_u), name


@pytest.mark.parametrize("shape", [(3, 8, 33), (4, 33, 129)])
def test_pruned_counts_equal_gathered_full_counts(shape):
    """K7's counts are the K2/K5 counts of the gathered bank, row c*M + m
    for clause sel[c, m] (the plain versions the card's kernels are held
    to), and the replica-first forms stack the one-replica ones."""
    C, J, L = shape
    f = L // 2
    rng = np.random.default_rng([*shape, 17])
    inc, lits, inc_w, lit_w = _packed_operands(rng, (3,), (1,), C, J, f, 4)
    inc, inc_w = _t(inc), t_packing.words_from_numpy(inc_w)
    lits, lit_w = _t(lits), t_packing.words_from_numpy(lit_w)
    sel = _t(_sels(rng, (3, C), J, J - 1)[1])
    viol, ninc = t_ce.clause_counts_batch_pruned_replicated(inc, sel, lits)
    violw = t_ce.clause_counts_batch_pruned_replicated_packed(inc_w, sel,
                                                              lit_w)
    assert viol.dtype == ninc.dtype == violw.dtype == torch.int32
    assert torch.equal(viol, violw)
    for r in range(3):
        gathered = t_ref.gather_include(inc[r], sel[r])
        v1, n1 = t_ce.clause_counts_batch(gathered.reshape(-1, 2 * f),
                                          lits[0])
        assert torch.equal(viol[r], v1) and torch.equal(ninc[r], n1)
        v2, n2 = t_ce.clause_counts_batch_pruned(inc[r], sel[r], lits[0])
        assert torch.equal(v2, v1) and torch.equal(n2, n1)
        assert torch.equal(t_ce.clause_counts_batch_pruned_packed(
            inc_w[r], sel[r], lit_w[0]), v1)


def test_gather_include_contract():
    """take_along_dim along J on bool and word banks alike, last axis
    untouched; ids outside [0, J) are rejected on the host."""
    rng = np.random.default_rng(5)
    inc = rng.random((2, 3, 6, 10)) < 0.5
    sel = rng.integers(0, 6, (2, 3, 4)).astype(np.int32)
    want = np.asarray(j_ref.gather_include(jnp.asarray(inc),
                                           jnp.asarray(sel)))
    assert np.array_equal(t_ref.gather_include(_t(inc), _t(sel)).numpy(),
                          want)
    words = rng.integers(0, 2**32, (2, 3, 6, 2), dtype=np.uint32)
    want_w = np.asarray(j_ref.gather_include(jnp.asarray(words),
                                             jnp.asarray(sel)))
    got_w = t_ref.gather_include(t_packing.words_from_numpy(words), _t(sel))
    assert np.array_equal(t_packing.words_to_numpy(got_w), want_w)
    for bad in (-1, 6):
        sel_bad = sel.copy()
        sel_bad[1, 2, 3] = bad
        with pytest.raises(ValueError, match="outside"):
            t_ref.gather_include(_t(inc), _t(sel_bad))
        with pytest.raises(ValueError, match="outside"):
            dispatch.resolve("cuda").clause_eval_batch_pruned_replicated(
                _t(inc), _t(sel_bad), _t(rng.random((1, 3, 10)) < 0.5),
                training=False)
    with pytest.raises(ValueError, match="M"):
        t_ce.clause_counts_batch_pruned(_t(inc[0]), _t(sel[0, :, :0]),
                                        _t(inc[0, 0, :2]))


# Word widths on the CUDA word body's edges and three kinds of words (as
# tests/test_torch_packing.py's EDGE_W and WORD_KINDS): random words;
# all-ones include words against literal rows of zeros, ones and random
# words; include words with their last word's high bits set against
# literals with them clear. Selections of every integer type the wrappers
# take, each holding ids 0 and J - 1.
EDGE_W = [1, 2, 3, 7, 8, 9, 50, 98, 700]
WORD_KINDS = ["random", "ones", "tail"]
SEL_DTYPES = [np.int16, np.uint8, np.int32, np.int64]


def _edge_words(rng, lead_inc, lead_lit, W, kind):
    def words(shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(
            np.uint32)

    inc, lit = words(lead_inc + (W,)), words(lead_lit + (W,))
    if kind == "ones":
        inc[...] = 0xFFFFFFFF
        lit[..., 0::3, :] = 0
        lit[..., 1::3, :] = 0xFFFFFFFF
    elif kind == "tail":
        inc[..., -1] |= np.uint32(0xFFFF0000)
        lit[..., -1] &= np.uint32(0x0000FFFF)
    return inc, lit


@pytest.mark.parametrize("W", EDGE_W)
@pytest.mark.parametrize("kind", WORD_KINDS)
def test_pruned_packed_counts_match_pallas_at_word_edges(W, kind):
    """K7 on words, replica-first (R = 4 banks of 3 x 10 clauses on D = 2
    streams) and K = 1, equals the Pallas packed counts of the gathered
    bank bit for bit, for every selection type."""
    R, D, C, J, M, B = 4, 2, 3, 10, 6, 7
    rng = np.random.default_rng([W, WORD_KINDS.index(kind), 19])
    inc, lit = _edge_words(rng, (R, C, J), (D, B), W, kind)
    sel = np.stack([np.stack([rng.permutation(J)[:M] for _ in range(C)])
                    for _ in range(R)])
    sel[:, 0, 0], sel[:, -1, -1] = 0, J - 1
    want = np.asarray(j_ce.clause_counts_batch_replicated_packed(
        j_ref.gather_include(jnp.asarray(inc), jnp.asarray(sel)).reshape(
            R, C * M, W), jnp.asarray(lit), interpret=True))
    want1 = np.asarray(j_ce.clause_counts_batch_packed(
        j_ref.gather_include(jnp.asarray(inc[0]), jnp.asarray(sel[0]))
        .reshape(C * M, W), jnp.asarray(lit[0]), interpret=True))
    t_inc = t_packing.words_from_numpy(inc)
    t_lit = t_packing.words_from_numpy(lit)
    for dt in SEL_DTYPES:
        t_sel = torch.from_numpy(sel.astype(dt))
        got = t_ce.clause_counts_batch_pruned_replicated_packed(t_inc, t_sel,
                                                                t_lit)
        assert got.dtype == torch.int32 and got.shape == (R, C * M, B)
        assert np.array_equal(got.numpy(), want), dt
        got1 = t_ce.clause_counts_batch_pruned_packed(t_inc[0], t_sel[0],
                                                      t_lit[0])
        assert np.array_equal(got1.numpy(), want1), dt


@pytest.mark.parametrize("dt", SEL_DTYPES)
def test_pruned_packed_eval_matches_pallas_for_every_sel_type(dt):
    """The packed budgeted outputs on both port backends equal the
    reference's Pallas entries (interpret mode) for each selection type,
    on packed-layout words at f = 49 (W = 4)."""
    R, D, C, J, f = 3, 3, 3, 8, 49
    rng = np.random.default_rng([19, np.dtype(dt).itemsize])
    inc, _, inc_w, lit_w = _packed_operands(rng, (R,), (D,), C, J, f, 5)
    sel = rng.integers(0, J, (R, C, 5))
    sel[:, 0, 0], sel[:, -1, -1] = 0, J - 1
    sel = sel.astype(dt)
    for training in (True, False):
        want = np.asarray(j_ops.clause_eval_batch_pruned_replicated_packed(
            jnp.asarray(inc_w), jnp.asarray(sel), jnp.asarray(lit_w),
            training=training))
        want1 = np.asarray(j_ops.clause_eval_batch_pruned_packed(
            jnp.asarray(inc_w[0]), jnp.asarray(sel[0]),
            jnp.asarray(lit_w[0]), training=training))
        for name in BACKENDS:
            kb = dispatch.resolve(name)
            got = kb.clause_eval_batch_pruned_replicated_packed(
                t_packing.words_from_numpy(inc_w), torch.from_numpy(sel),
                t_packing.words_from_numpy(lit_w), training=training)
            assert np.array_equal(got.numpy(), want), (name, training)
            got1 = kb.clause_eval_batch_pruned_packed(
                t_packing.words_from_numpy(inc_w[0]),
                torch.from_numpy(sel[0]),
                t_packing.words_from_numpy(lit_w[0]), training=training)
            assert np.array_equal(got1.numpy(), want1), (name, training)


# ---------------------------------------------------------------------------
# Budgeted inference: votes, predictions and accuracy against the JAX core
# ---------------------------------------------------------------------------

F, C, J, N = 16, 3, 8, 32


def _cfgs(backend="ref"):
    jc = JConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N)
    tc = TConfig(n_features=F, max_classes=C, max_clauses=J, n_states=N,
                 backend=backend)
    return jc, tc


def _bank_state(seed, replicas=None):
    rng = np.random.default_rng(seed)
    shape = (C, J, 2 * F) if replicas is None else (replicas, C, J, 2 * F)
    return rng.integers(1, 2 * N + 1, shape).astype(np.int8)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_forward_batch_pruned_votes_match_jax(backend, packed, weighted):
    jc, tc = _cfgs(backend)
    rng = np.random.default_rng([int(packed), int(weighted), 3])
    ta = _bank_state(21)
    X = rng.random((40, F)) < 0.5
    jrt = j_init_runtime(jc, n_active_clauses=6)
    trt = t_init_runtime(tc, n_active_clauses=6, device="cpu")
    jst = j_tm.TMState(ta_state=jnp.asarray(ta))
    tst = t_tm.TMState(ta_state=torch.from_numpy(ta))
    xj = (j_packing.pack_bits(jnp.asarray(X)) if packed
          else jnp.asarray(X))
    xt = (t_packing.words_from_numpy(np.asarray(xj)) if packed
          else torch.from_numpy(X))
    w = rng.integers(1, 8, (C, J)).astype(np.int32) if weighted else None
    for M in (1, 5, J):
        sel = np.stack([rng.permutation(J)[:M] for _ in range(C)]
                       ).astype(np.int32)
        jcl, jv = j_tm.forward_batch_pruned(
            jc, jst, jrt, xj, jnp.asarray(sel),
            None if w is None else jnp.asarray(w))
        tcl, tv = t_tm.forward_batch_pruned(
            tc, tst, trt, xt, sel, None if w is None else torch.from_numpy(w))
        assert tv.dtype == torch.int32 and np.asarray(jv).dtype == np.int32
        assert np.array_equal(np.asarray(jcl), tcl.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
        jp = np.asarray(j_tm.predict_batch_pruned(
            jc, jst, jrt, xj, jnp.asarray(sel),
            None if w is None else jnp.asarray(w)))
        tp = t_tm.predict_batch_pruned(tc, tst, trt, xt, torch.from_numpy(sel),
                                       w)
        assert np.array_equal(jp, tp.numpy())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("packed", [False, True])
def test_forward_batch_pruned_replicated_votes_match_jax(backend, packed):
    R, D = 4, 2
    jc, tc = _cfgs(backend)
    rng = np.random.default_rng([int(packed), 5])
    ta = _bank_state(23, replicas=R)
    X = rng.random((D, 20, F)) < 0.5
    cmask = np.array([True, False, True])
    jrt = j_init_runtime(jc)._replace(class_mask=jnp.asarray(cmask))
    trt = t_init_runtime(tc, device="cpu")._replace(
        class_mask=torch.from_numpy(cmask))
    jst = j_tm.TMState(ta_state=jnp.asarray(ta))
    tst = t_tm.TMState(ta_state=torch.from_numpy(ta))
    xj = (j_packing.pack_bits(jnp.asarray(X)) if packed
          else jnp.asarray(X))
    xt = (t_packing.words_from_numpy(np.asarray(xj)) if packed
          else torch.from_numpy(X))
    for weighted in (False, True):
        w = (rng.integers(1, 16, (R, C, J)).astype(np.int32) if weighted
             else None)
        sel = rng.integers(0, J, (R, C, 3)).astype(np.int32)
        jw = None if w is None else jnp.asarray(w)
        jcl, jv = j_tm.forward_batch_pruned_replicated(
            jc, jst, jrt, xj, jnp.asarray(sel), jw)
        tcl, tv = t_tm.forward_batch_pruned_replicated(tc, tst, trt, xt, sel,
                                                       w)
        assert tv.dtype == torch.int32
        assert np.array_equal(np.asarray(jcl), tcl.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
        jp = np.asarray(j_tm.predict_batch_pruned_replicated(
            jc, jst, jrt, xj, jnp.asarray(sel), jw))
        tp = t_tm.predict_batch_pruned_replicated(tc, tst, trt, xt, sel, w)
        assert tp.dtype == torch.int32
        assert np.array_equal(jp, tp.numpy())
        assert not (tp.numpy() == 1).any()      # a masked class never wins


@pytest.mark.parametrize("masked", [False, True])
def test_analyze_pruned_matches_jax(masked):
    jc, tc = _cfgs("cuda")
    rng = np.random.default_rng([int(masked), 9])
    X = rng.random((30, F)) < 0.5
    Y = rng.integers(0, C, 30).astype(np.int32)
    valid = rng.random(30) < 0.7 if masked else None
    ta = _bank_state(25)
    jrt, trt = j_init_runtime(jc), t_init_runtime(tc, device="cpu")
    sel = np.stack([rng.permutation(J) for _ in range(C)]).astype(np.int32)
    w = rng.integers(1, 8, (C, J)).astype(np.int32)
    for s, ww in ((sel, None), (sel[:, :3], w)):
        a = np.asarray(j_acc.analyze_pruned(
            jc, j_tm.TMState(jnp.asarray(ta)), jrt, jnp.asarray(X),
            jnp.asarray(Y), jnp.asarray(s),
            None if ww is None else jnp.asarray(ww),
            None if valid is None else jnp.asarray(valid)))
        b = t_acc.analyze_pruned(
            tc, t_tm.TMState(torch.from_numpy(ta)), trt, torch.from_numpy(X),
            torch.from_numpy(Y), s, ww,
            None if valid is None else torch.from_numpy(valid))
        assert b.dtype == torch.float32
        assert np.asarray(a).view(np.int32) == b.numpy().view(np.int32)
    # a full permutation with unit weights is analyze, bit for bit
    full = t_acc.analyze(tc, t_tm.TMState(torch.from_numpy(ta)), trt,
                         torch.from_numpy(X), torch.from_numpy(Y))
    assert full.numpy().view(np.int32) == t_acc.analyze_pruned(
        tc, t_tm.TMState(torch.from_numpy(ta)), trt, torch.from_numpy(X),
        torch.from_numpy(Y), sel).numpy().view(np.int32)


def test_analyze_pruned_replicated_matches_jax():
    R, D = 4, 2
    jc, tc = _cfgs("cuda")
    rng = np.random.default_rng(31)
    X = rng.random((D, 25, F)) < 0.5
    Y = rng.integers(0, C, (D, 25)).astype(np.int32)
    ta = _bank_state(27, replicas=R)
    sel = np.stack([np.stack([rng.permutation(J)[:5] for _ in range(C)])
                    for _ in range(R)]).astype(np.int32)
    for valid in (None, rng.random((D, 25)) < 0.6):
        a = np.asarray(j_acc.analyze_pruned_replicated(
            jc, j_tm.TMState(jnp.asarray(ta)), j_init_runtime(jc),
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(sel), None,
            None if valid is None else jnp.asarray(valid)))
        b = t_acc.analyze_pruned_replicated(
            tc, convert.state_from_numpy(j_tm.TMState(ta), "cpu"),
            t_init_runtime(tc, device="cpu"), torch.from_numpy(X),
            torch.from_numpy(Y), sel, None,
            None if valid is None else torch.from_numpy(valid))
        assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))
