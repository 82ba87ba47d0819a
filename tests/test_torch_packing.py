"""The port's bit-packed datapath against the JAX package, bit for bit.

* the packing layout (round trip, tail bits zero, LSB-first word-major,
  the two-half literal split, ``pack_include`` positions) against
  ``repro.kernels.packing``, with words as the port's int32 bit patterns;
* K5 and K6 (``clause_eval_batch_packed``, ``..._replicated_packed``) on
  both port backends -- on the CPU each runs its plain SWAR-popcount
  version -- against ``repro.kernels.ref`` and ``repro.kernels.ops`` (the
  Pallas kernels in interpret mode), over ``tests/test_packing.py``'s
  widths and (R, D) grid, and the counts against the unpacked K2/K4;
* the K5/K6 counts against the Pallas kernels (interpret mode) at the
  word widths on the CUDA body's copy, step and chunk edges (W = 1 to
  700), on random words, all-ones include words and include words with
  tail bits set, as int32 and as uint32 tensors;
* the dtype routing of ``core/tm`` and the fault controller commuting with
  packing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JConfig
from repro.core import faults as j_faults
from repro.core import init_runtime as j_init_runtime
from repro.core import init_state as j_init_state
from repro.core import tm as j_tm
from repro.kernels import clause_eval as j_ce
from repro.kernels import ops as j_ops
from repro.kernels import packing as j_packing
from repro.kernels import ref as j_ref
from repro_torch.core import TMConfig as TConfig
from repro_torch.core import faults as t_faults
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import tm as t_tm
from repro_torch.kernels import clause_eval as t_ce
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import packing as t_packing
from repro_torch.kernels import ref as t_ref

LAYOUT_WIDTHS = [1, 5, 31, 32, 33, 63, 64, 65, 196, 784]
# tests/test_packing.py's clause-eval widths: sub-word, word +- 1,
# multi-word with a tail, the benchmark widths.
WIDTHS = [5, 16, 31, 32, 33, 49, 196, 513, 784]
J_MODS = {"ref": j_ref, "pallas": j_ops}
T_MODS = {"ref": t_ref, "cuda": t_ops}


def _u32(words: torch.Tensor) -> np.ndarray:
    return t_packing.words_to_numpy(words)


@pytest.mark.parametrize("n", LAYOUT_WIDTHS)
def test_pack_round_trip_and_tail_zero(n):
    rng = np.random.default_rng(n * 7919)
    bits = rng.random((5, 3, n)) < 0.5
    want = np.asarray(j_packing.pack_bits(jnp.asarray(bits)))
    words = t_packing.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    assert words.shape == (5, 3, t_packing.n_words(n))
    assert np.array_equal(_u32(words), want)
    assert np.array_equal(t_packing.pack_bits_np(bits), want)
    assert np.array_equal(t_packing.unpack_bits(words, n).numpy(), bits)
    assert np.array_equal(t_packing.unpack_bits(words.view(torch.uint32), n)
                          .numpy(), bits)
    assert np.array_equal(t_packing.unpack_bits_np(want, n), bits)
    tail = _u32(words)[..., -1]
    assert (tail & ~np.uint32(t_packing.tail_mask(n))).max(initial=0) == 0
    assert np.array_equal(_u32(t_packing.word_mask(n)),
                          np.asarray(j_packing.word_mask(n)))
    # every bit set: the top word is negative as an int32, and still packs
    ones = np.ones((2, n), dtype=bool)
    assert np.array_equal(_u32(t_packing.pack_bits(torch.from_numpy(ones))),
                          np.asarray(j_packing.pack_bits(jnp.asarray(ones))))
    assert t_packing.packed_row_bytes(n) == j_packing.packed_row_bytes(n)


@pytest.mark.parametrize("f", [5, 31, 33, 49])
def test_literal_layout_two_halves(f):
    rng = np.random.default_rng(f)
    x = rng.random((4, f)) < 0.5
    want = np.asarray(j_packing.pack_literals(jnp.asarray(x)))
    lit = t_packing.pack_literals(torch.from_numpy(x))
    assert lit.shape == (4, t_packing.lit_words(f)) == want.shape
    assert np.array_equal(_u32(lit), want)
    from_words = t_tm.make_literals_packed(
        t_packing.words_from_numpy(j_packing.pack_bits_np(x)), f)
    assert np.array_equal(_u32(from_words), want)


@pytest.mark.parametrize("f", [5, 31, 33, 49])
def test_pack_include_matches_literal_positions(f):
    rng = np.random.default_rng(100 + f)
    inc = rng.random((3, 2, 2 * f)) < 0.3
    want = np.asarray(j_packing.pack_include(jnp.asarray(inc), f))
    words = t_packing.pack_include(torch.from_numpy(inc), f)
    assert np.array_equal(_u32(words), want)
    Wf = t_packing.n_words(f)
    assert np.array_equal(t_packing.unpack_bits(words[..., :Wf], f).numpy(),
                          inc[..., :f])
    assert np.array_equal(t_packing.unpack_bits(words[..., Wf:], f).numpy(),
                          inc[..., f:])


def test_popcount_counts_every_bit():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555,
                  0xAAAAAAAA], dtype=np.uint32),
        rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)])
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(-1)
    got = t_ref.popcount(t_packing.words_from_numpy(words))
    assert np.array_equal(got.numpy(), want)


def _case(f, seed, C=3, J=6, B=17):
    rng = np.random.default_rng(seed)
    include = rng.random((C, J, 2 * f)) < 0.3
    x = rng.random((B, f)) < 0.5
    return include, x


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("jmod", ["ref", "pallas"])
def test_clause_eval_batch_packed_matches_reference(f, jmod):
    include, x = _case(f, seed=f)
    inc_p = j_packing.pack_include(jnp.asarray(include), f)
    lit_p = j_packing.pack_literals(jnp.asarray(x))
    t_inc = t_packing.words_from_numpy(np.asarray(inc_p))
    t_lit = t_packing.words_from_numpy(np.asarray(lit_p))
    for training in (True, False):
        want = np.asarray(J_MODS[jmod].clause_eval_batch_packed(
            inc_p, lit_p, training=training))
        for tmod in T_MODS.values():
            got = tmod.clause_eval_batch_packed(t_inc, t_lit,
                                                training=training)
            assert np.array_equal(got.numpy(), want)
    # K5's counts equal K2's on the unpacked operands (packed == unpacked)
    lits = np.concatenate([x, ~x], -1)
    viol = t_ce.clause_counts_batch_packed(t_inc.reshape(-1, t_inc.shape[-1]),
                                           t_lit)
    viol_u, _ = t_ce.clause_counts_batch(
        torch.from_numpy(include.reshape(-1, 2 * f)), torch.from_numpy(lits))
    assert torch.equal(viol, viol_u)


@pytest.mark.parametrize("jmod", ["ref", "pallas"])
def test_clause_eval_batch_packed_empty_and_all_include(jmod):
    f = 33
    x = np.random.default_rng(0).random((5, f)) < 0.5
    lit_p = j_packing.pack_literals(jnp.asarray(x))
    t_lit = t_packing.words_from_numpy(np.asarray(lit_p))
    for inc in (np.zeros((2, 4, 2 * f), bool), np.ones((2, 4, 2 * f), bool)):
        inc_p = j_packing.pack_include(jnp.asarray(inc), f)
        t_inc = t_packing.words_from_numpy(np.asarray(inc_p))
        for training in (True, False):
            want = np.asarray(J_MODS[jmod].clause_eval_batch_packed(
                inc_p, lit_p, training=training))
            for tmod in T_MODS.values():
                got = tmod.clause_eval_batch_packed(t_inc, t_lit,
                                                    training=training)
                assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("f", [16, 31, 49, 196])
@pytest.mark.parametrize("RD", [(1, 1), (4, 2), (3, 3)])
@pytest.mark.parametrize("jmod", ["ref", "pallas"])
def test_clause_eval_batch_replicated_packed_matches_reference(f, RD, jmod):
    R, D = RD
    rng = np.random.default_rng(f * 100 + R * 10 + D)
    include = rng.random((R, 3, 6, 2 * f)) < 0.3
    x = rng.random((D, 9, f)) < 0.5
    inc_p = j_packing.pack_include(jnp.asarray(include), f)
    lit_p = j_packing.pack_literals(jnp.asarray(x))
    t_inc = t_packing.words_from_numpy(np.asarray(inc_p))
    t_lit = t_packing.words_from_numpy(np.asarray(lit_p))
    for training in (True, False):
        want = np.asarray(J_MODS[jmod].clause_eval_batch_replicated_packed(
            inc_p, lit_p, training=training))
        for tmod in T_MODS.values():
            got = tmod.clause_eval_batch_replicated_packed(
                t_inc, t_lit, training=training)
            assert np.array_equal(got.numpy(), want)
    # K6's counts equal K4's on the unpacked operands
    lits = np.concatenate([x, ~x], -1)
    viol = t_ce.clause_counts_batch_replicated_packed(
        t_inc.reshape(R, 18, -1), t_lit)
    viol_u, _ = t_ce.clause_counts_batch_replicated(
        torch.from_numpy(include.reshape(R, 18, 2 * f)),
        torch.from_numpy(lits))
    assert torch.equal(viol, viol_u)


def test_packed_replicated_rejects_bad_data_axis():
    f = 16
    inc_p = t_packing.pack_include(torch.zeros(4, 1, 2, 2 * f, dtype=bool), f)
    lit_p = t_packing.pack_literals(torch.zeros(3, 5, f, dtype=bool))
    for fn in (t_ref.clause_eval_batch_replicated_packed,
               t_ops.clause_eval_batch_replicated_packed):
        with pytest.raises(ValueError, match="must divide"):
            fn(inc_p, lit_p, training=False)


@pytest.mark.parametrize("f", [16, 49])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_forward_batch_routes_packed_by_dtype(f, backend):
    """forward_batch / forward_batch_replicated on packed words equal the
    bool route and the reference's packed route."""
    kw = dict(n_features=f, max_classes=3, max_clauses=8, n_states=50)
    jc, tc = JConfig(**kw), TConfig(backend=backend, **kw)
    rng = np.random.default_rng(f)
    bank = rng.integers(1, 101, (3, 8, 2 * f)).astype(np.int8)
    js = j_init_state(jc)._replace(ta_state=jnp.asarray(bank))
    ts = t_tm.TMState(torch.from_numpy(bank))
    jr, tr = j_init_runtime(jc), t_init_runtime(tc, device="cpu")
    xs = rng.random((11, f)) < 0.5
    words = t_packing.words_from_numpy(j_packing.pack_bits_np(xs))
    for training in (True, False):
        jcl, jv = j_tm.forward_batch(jc, js, jr, j_packing.pack_bits(
            jnp.asarray(xs)), training=training)
        for rows in (torch.from_numpy(xs), words):
            tcl, tv = t_tm.forward_batch(tc, ts, tr, rows, training=training)
            assert np.array_equal(tcl.numpy(), np.asarray(jcl))
            assert np.array_equal(tv.numpy(), np.asarray(jv))
    banks = torch.from_numpy(np.stack([bank, bank[::-1].copy()]))
    rows2 = torch.stack([words, words.flip(0)])
    p_words = t_tm.predict_batch_replicated(tc, t_tm.TMState(banks), tr,
                                            rows2)
    p_bool = t_tm.predict_batch_replicated(
        tc, t_tm.TMState(banks), tr,
        torch.stack([torch.from_numpy(xs), torch.from_numpy(xs).flip(0)]))
    assert torch.equal(p_words, p_bool)


@pytest.mark.parametrize("f", [16, 49])
@pytest.mark.parametrize("stuck_value", [0, 1])
def test_stuck_at_faults_commute_with_packing(f, stuck_value):
    """A fault applied before the pack equals the fault applied on packed
    include words, and both equal the reference's words."""
    kw = dict(n_features=f, max_classes=3, max_clauses=8, n_states=50)
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(f + stuck_value)
    bank = rng.integers(1, 101, (3, 8, 2 * f)).astype(np.int8)
    js = j_init_state(jc)._replace(ta_state=jnp.asarray(bank))
    ts = t_tm.TMState(torch.from_numpy(bank))
    a, o = j_faults.random_stuck_at(jc, 0.1, stuck_value, seed=7)
    assert all(np.array_equal(p, q) for p, q in zip(
        (a, o), t_faults.random_stuck_at(tc, 0.1, stuck_value, seed=7)))
    jr = j_faults.inject(j_init_runtime(jc), a, o)
    tr = t_faults.inject(t_init_runtime(tc, device="cpu"), a, o)
    want = np.asarray(j_tm.ta_actions_packed(jc, js, jr))
    pre = t_tm.ta_actions_packed(tc, ts, tr)
    clean = t_tm.ta_actions(tc, ts, t_faults.clear(tc, tr))
    a_p, o_p = t_faults.packed_masks(tc, tr)
    for p, q in zip((a_p, o_p), j_faults.packed_masks(jc, jr)):
        assert np.array_equal(_u32(p), np.asarray(q))
    post = t_faults.apply_packed(t_packing.pack_include(clean, f), a_p, o_p)
    assert np.array_equal(_u32(pre), want)
    assert np.array_equal(_u32(post), want)


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_faulted_packed_eval_matches_unpacked(backend):
    f = 49
    kw = dict(n_features=f, max_classes=2, max_clauses=6, n_states=50)
    tc = TConfig(backend=backend, **kw)
    rng = np.random.default_rng(3)
    ts = t_tm.TMState(torch.from_numpy(
        rng.integers(1, 101, (2, 6, 2 * f)).astype(np.int8)))
    a, o = t_faults.even_spread_stuck_at(tc, 0.2, 1)
    tr = t_faults.inject(t_init_runtime(tc, device="cpu"), a, o)
    xs = torch.from_numpy(rng.random((13, f)) < 0.5)
    cl_a, v_a = t_tm.forward_batch(tc, ts, tr, xs)
    cl_b, v_b = t_tm.forward_batch(tc, ts, tr, t_packing.pack_bits(xs))
    assert torch.equal(cl_a, cl_b) and torch.equal(v_a, v_b)


# Word widths on the edges of the CUDA word body (tests/test_torch_gpu.py
# holds the body itself on the card): the 4- and 8-byte copies (W odd,
# W % 4 == 2), the 16-byte copy (W % 4 == 0), the 8-word b1 product step,
# the 16-word chunk, and 700 words (beyond the shared-memory cap the old
# counting kernel had). Three kinds of words: random words on both sides;
# all-ones include words against literal rows of zeros, ones and random
# words (sums up to 32 * W); random include words whose last word has its
# high bits set, against literals whose last word has them clear, as
# include tail bits past a packed width would be.
EDGE_W = [1, 2, 3, 7, 8, 9, 50, 98, 700]
WORD_KINDS = ["random", "ones", "tail"]


def edge_words(rng, lead_inc, lead_lit, W, kind):
    """(include, literals) np.uint32 words [*lead_inc, W], [*lead_lit, W]
    of ``kind`` (WORD_KINDS)."""
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


def _as_uint32(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32)).view(torch.uint32)


@pytest.mark.parametrize("W", EDGE_W)
@pytest.mark.parametrize("kind", WORD_KINDS)
def test_batch_packed_counts_match_pallas_at_word_edges(W, kind):
    """K5's counts equal the Pallas ``clause_counts_batch_packed``'s bit for
    bit, on int32 and on uint32 word tensors."""
    rng = np.random.default_rng([W, WORD_KINDS.index(kind)])
    for cj, B in ((37, 9), (5, 1)):
        inc, lit = edge_words(rng, (cj,), (B,), W, kind)
        want = np.asarray(j_ce.clause_counts_batch_packed(
            jnp.asarray(inc), jnp.asarray(lit), interpret=True))
        got = t_ce.clause_counts_batch_packed(
            t_packing.words_from_numpy(inc), t_packing.words_from_numpy(lit))
        assert got.dtype == torch.int32 and got.shape == (cj, B)
        assert np.array_equal(got.numpy(), want), (cj, B)
        got_u = t_ce.clause_counts_batch_packed(_as_uint32(inc),
                                                _as_uint32(lit))
        assert np.array_equal(got_u.numpy(), want), (cj, B)
    if kind == "ones":
        assert want.max() == 32 * W


@pytest.mark.parametrize("W", EDGE_W)
@pytest.mark.parametrize("kind", WORD_KINDS)
def test_batch_replicated_packed_counts_match_pallas_at_word_edges(W, kind):
    """K6's counts (R = 4 banks on D = 2 streams, and R = D = 3) equal the
    Pallas ``clause_counts_batch_replicated_packed``'s bit for bit."""
    rng = np.random.default_rng([W, WORD_KINDS.index(kind), 6])
    for R, D, cj, B in ((4, 2, 10, 5), (3, 3, 7, 8)):
        inc, lit = edge_words(rng, (R, cj), (D, B), W, kind)
        want = np.asarray(j_ce.clause_counts_batch_replicated_packed(
            jnp.asarray(inc), jnp.asarray(lit), interpret=True))
        got = t_ce.clause_counts_batch_replicated_packed(
            t_packing.words_from_numpy(inc), t_packing.words_from_numpy(lit))
        assert got.dtype == torch.int32 and got.shape == (R, cj, B)
        assert np.array_equal(got.numpy(), want), (R, D)
        got_u = t_ce.clause_counts_batch_replicated_packed(_as_uint32(inc),
                                                           _as_uint32(lit))
        assert np.array_equal(got_u.numpy(), want), (R, D)
