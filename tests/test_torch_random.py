"""The port's threefry RNG against ``jax.random``, bit for bit.

Hypothesis draws seeds, counts, fold-in data and shapes; every draw of
``repro_torch.random`` must equal the reference's draw from the same key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as rnd

hypothesis = pytest.importorskip(
    "hypothesis", reason="optional dev dependency (requirements-dev.txt)"
)
from hypothesis import given, settings, strategies as st  # noqa: E402

SEEDS = st.integers(0, 2**31 - 1)
# A few shapes, so each jitted reference draw compiles once per shape.
SHAPES = st.sampled_from([(1,), (3,), (16,), (4, 5), (3, 16, 32), (2, 3, 7)])
CFG = settings(max_examples=25, deadline=None, database=None)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@CFG
@given(seed=SEEDS)
def test_prngkey(seed):
    assert np.array_equal(_words(jax.random.PRNGKey(seed)),
                          rnd.PRNGKey(seed).numpy())


@CFG
@given(seed=SEEDS, num=st.integers(1, 9))
def test_split(seed, num):
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    assert np.array_equal(_words(want), rnd.split(rnd.PRNGKey(seed), num).numpy())


@CFG
@given(seed=SEEDS, data=st.integers(0, 2**31 - 1))
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    got = rnd.fold_in(rnd.PRNGKey(seed), data)
    assert np.array_equal(_words(want), got.numpy())


@CFG
@given(seed=SEEDS, data=st.lists(st.integers(0, 2**32 - 1), min_size=1,
                                 max_size=9))
def test_fold_in_many_data(seed, data):
    """A sequence of data folds into one key each, in one call: the
    service keys a fleet of K this way (``fold_in(PRNGKey(seed), r)``)."""
    key = jax.random.PRNGKey(seed)
    want = jnp.stack([jax.random.fold_in(key, d) for d in data])
    got = rnd.fold_in(rnd.PRNGKey(seed), np.asarray(data))
    assert got.shape == (len(data), 2)
    assert np.array_equal(_words(want), got.numpy())


@CFG
@given(seed=SEEDS, shape=SHAPES)
def test_uniform_bits(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = rnd.uniform(rnd.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@CFG
@given(seed=SEEDS, shape=SHAPES)
def test_bernoulli(seed, shape):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, shape))
    got = rnd.bernoulli(rnd.PRNGKey(seed), 0.5, shape).numpy()
    assert np.array_equal(want, got)


@CFG
@given(seed=SEEDS, n=st.integers(1, 12), data=st.data())
def test_categorical_masked_logits(seed, n, data):
    """The selection core's draw: logits 0 (allowed) or -inf (masked),
    including the all-masked row."""
    mask = np.asarray(data.draw(st.lists(st.booleans(), min_size=n,
                                         max_size=n)))
    key_j, key_t = jax.random.PRNGKey(seed), rnd.PRNGKey(seed)
    for _ in range(4):
        key_j, sub_j = jax.random.split(key_j)
        key_t, sub_t = rnd.split(key_t)
        want = int(jax.random.categorical(
            sub_j, jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)))
        got = int(rnd.categorical(
            sub_t, torch.where(torch.from_numpy(mask), 0.0, float("-inf"))))
        assert want == got


def test_key_schedule_chain():
    """A long chain of split / fold_in, as the service advances its keys."""
    kj, kt = jax.random.PRNGKey(7), rnd.PRNGKey(7)
    for i in range(50):
        kj = jax.random.fold_in(jax.random.split(kj)[i % 2], i)
        kt = rnd.fold_in(rnd.split(kt)[i % 2], i)
    assert np.array_equal(_words(kj), kt.numpy())


# Batched keys [D, 2]: each form equals jax.vmap of the single-key function.
def _key_batch(seed, d):
    kj = jax.random.split(jax.random.PRNGKey(seed), d)
    return kj, torch.from_numpy(_words(kj))


@CFG
@given(seed=SEEDS, d=st.integers(1, 6), num=st.integers(1, 5))
def test_split_batched(seed, d, num):
    kj, kt = _key_batch(seed, d)
    want = jax.vmap(lambda k: jax.random.split(k, num))(kj)
    got = rnd.split(kt, num)
    assert got.shape == (d, num, 2)
    assert np.array_equal(_words(want), got.numpy())


@CFG
@given(seed=SEEDS, d=st.integers(1, 6), data=st.integers(0, 2**31 - 1))
def test_fold_in_batched(seed, d, data):
    kj, kt = _key_batch(seed, d)
    want = jax.vmap(lambda k: jax.random.fold_in(k, data))(kj)
    got = rnd.fold_in(kt, data)
    assert got.shape == (d, 2)
    assert np.array_equal(_words(want), got.numpy())


@CFG
@given(seed=SEEDS, d=st.integers(1, 6), shape=SHAPES)
def test_uniform_batched(seed, d, shape):
    kj, kt = _key_batch(seed, d)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(kj))
    got = rnd.uniform(kt, shape).numpy()
    assert got.shape == (d,) + shape
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


@CFG
@given(seed=SEEDS, d=st.integers(1, 6), n=st.integers(1, 8), data=st.data())
def test_categorical_batched(seed, d, n, data):
    """Row r of a batched masked-logit draw uses key r, as a vmap does."""
    mask = np.asarray(data.draw(st.lists(
        st.lists(st.booleans(), min_size=n, max_size=n),
        min_size=d, max_size=d)))
    kj, kt = _key_batch(seed, d)
    logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(kj, jnp.asarray(logits))
    got = rnd.categorical(kt, torch.from_numpy(logits))
    assert np.array_equal(np.asarray(want), got.numpy())


@CFG
@given(seed=SEEDS, d=st.integers(1, 6), n=st.integers(1, 300))
def test_card_threefry_path_equals_the_cpu_path(seed, d, n):
    """CPU tensors run the rounds in numpy's uint32; the card runs them as
    torch ops on masked int64 (``_threefry_torch``). On the same words,
    here on the CPU, both give the same blocks, so the tests above hold
    the card's path to ``jax.random`` too."""
    keys = rnd.split(rnd.PRNGKey(seed), d)
    k0, k1 = rnd._words(keys)
    hi, lo = rnd._counters(n, "cpu")
    lo = lo + (2**32 - 1 - n)                      # words near the top
    for got, want in zip(rnd.threefry2x32(k0, k1, hi, lo),
                         rnd._threefry_torch(k0, k1, hi, lo)):
        assert got.dtype == want.dtype == torch.int64
        assert got.shape == want.shape == (d, n)
        assert torch.equal(got, want)
