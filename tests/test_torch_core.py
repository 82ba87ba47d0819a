"""The port's TM core against the reference on the iris machine, bitwise.

Same seed, same inputs (numpy), same keys: forward/predict, one
``train_update``/``train_step``, and whole ``train_epochs`` runs must give
the reference's clause outputs, votes, activities and TA banks bit for
bit, on both of the port's backends. Also the ``convert`` round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feedback as j_fb
from repro.core import tm as j_tm
from repro.data import iris as j_iris
from repro_torch import convert
from repro_torch.core import feedback as t_fb
from repro_torch.core import tm as t_tm

SEEDS = [0, 1, 2]
BACKENDS = ["cuda", "ref"]


def _cfgs(backend, **kw):
    base = dict(n_features=16, max_classes=3, max_clauses=16, n_states=16)
    base.update(kw)
    return j_tm.TMConfig(**base), t_tm.TMConfig(backend=backend, **base)


def _machines(seed, backend, s=1.375, T=15, **kw):
    """(jax cfg, state, rt), (torch cfg, state, rt) from one seed."""
    jc, tc = _cfgs(backend, **kw)
    js = j_tm.init_state(jc, jax.random.PRNGKey(seed))
    ts = t_tm.init_state(tc, convert.key_from_numpy(
        np.asarray(jax.random.PRNGKey(seed)), "cpu"), device="cpu")
    assert np.array_equal(np.asarray(js.ta_state), ts.ta_state.numpy())
    jr = j_tm.init_runtime(jc, s=s, T=T)
    tr = t_tm.init_runtime(tc, s=s, T=T, device="cpu")
    return (jc, js, jr), (tc, ts, tr)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_and_predict(seed, backend):
    (jc, js, jr), (tc, ts, tr) = _machines(seed, backend)
    xs, _ = j_iris.load()
    for training in (True, False):
        jcl, jv = j_tm.forward(jc, js, jr, jnp.asarray(xs[3]), training=training)
        tcl, tv = t_tm.forward(tc, ts, tr, torch.from_numpy(xs[3]),
                               training=training)
        assert np.array_equal(np.asarray(jcl), tcl.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
    jp = j_tm.predict_batch(jc, js, jr, jnp.asarray(xs))
    tp = t_tm.predict_batch(tc, ts, tr, torch.from_numpy(xs))
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert int(j_tm.predict(jc, js, jr, jnp.asarray(xs[7]))) == int(
        t_tm.predict(tc, ts, tr, torch.from_numpy(xs[7])))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_train_update_and_step(seed, backend):
    """One step from a trained-looking bank, with a class masked off so the
    non-target draw sees a masked logit."""
    (jc, js, jr), (tc, ts, tr) = _machines(seed, backend, s=1.375)
    jr = jr._replace(class_mask=jnp.asarray([True, True, False]))
    tr = tr._replace(class_mask=torch.tensor([True, True, False]))
    xs, ys = j_iris.load()
    key = jax.random.PRNGKey(100 + seed)
    tkey = convert.key_from_numpy(np.asarray(key), "cpu")
    x, y = xs[seed * 11], np.int32(ys[seed * 11] % 2)
    jst, jv, ja = j_fb.train_update(jc, js, jr, jnp.asarray(x), jnp.int32(y), key)
    tst, tv, ta = t_fb.train_update(tc, ts, tr, torch.from_numpy(x),
                                    torch.tensor(y), tkey)
    assert np.array_equal(np.asarray(jst.ta_state), tst.ta_state.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(_bits(ja), _bits(ta.numpy()))
    jst2, jaux = j_fb.train_step(jc, js, jr, jnp.asarray(x), jnp.int32(y), key)
    tst2, taux = t_fb.train_step(tc, ts, tr, torch.from_numpy(x),
                                 torch.tensor(y), tkey)
    assert np.array_equal(np.asarray(jst2.ta_state), tst2.ta_state.numpy())
    for f in jaux._fields:
        assert np.array_equal(_bits(getattr(jaux, f)),
                              _bits(getattr(taux, f).numpy())), f


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_train_epochs_ta_banks(seed, backend):
    """The offline phase: 20 rows x 4 epochs, TA banks bitwise."""
    (jc, js, jr), (tc, ts, tr) = _machines(seed, backend)
    xs, ys = j_iris.load()
    order = np.random.default_rng(seed).permutation(len(xs))[:20]
    key = jax.random.PRNGKey(seed + 1)
    want = j_fb.train_epochs(jc, js, jr, jnp.asarray(xs[order]),
                             jnp.asarray(ys[order]), key, 4)
    got = t_fb.train_epochs(tc, ts, tr, torch.from_numpy(xs[order]),
                            torch.from_numpy(ys[order]),
                            convert.key_from_numpy(np.asarray(key), "cpu"), 4)
    assert np.array_equal(np.asarray(want.ta_state), got.ta_state.numpy())
    assert not np.array_equal(np.asarray(js.ta_state), got.ta_state.numpy())


def test_train_datapoints_valid_mask_and_aux():
    (jc, js, jr), (tc, ts, tr) = _machines(5, "cuda")
    xs, ys = j_iris.load()
    valid = np.arange(12) % 3 != 1
    key = jax.random.PRNGKey(9)
    jst, jaux = j_fb.train_datapoints(jc, js, jr, jnp.asarray(xs[:12]),
                                      jnp.asarray(ys[:12]), key,
                                      jnp.asarray(valid))
    tst, taux = t_fb.train_datapoints(
        tc, ts, tr, torch.from_numpy(xs[:12]), torch.from_numpy(ys[:12]),
        convert.key_from_numpy(np.asarray(key), "cpu"),
        torch.from_numpy(valid))
    assert np.array_equal(np.asarray(jst.ta_state), tst.ta_state.numpy())
    for f in jaux._fields:
        assert np.array_equal(_bits(getattr(jaux, f)),
                              _bits(getattr(taux, f).numpy())), f


def test_convert_round_trip():
    jc, tc = _cfgs("cuda")
    js = j_tm.init_state(jc, jax.random.PRNGKey(3))
    jr = j_tm.init_runtime(jc, s=2.5, T=9, n_active_classes=2)
    jr = jr._replace(ta_or_mask=jr.ta_or_mask.at[1, 2, 3].set(True))
    tst = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    trt = convert.runtime_from_numpy(jax.tree.map(np.asarray, jr), "cpu")
    assert tst.ta_state.dtype == torch.int8
    assert trt.s.dtype == torch.float32 and trt.T.dtype == torch.int32
    back_s = convert.to_numpy(tst)
    back_r = convert.to_numpy(trt)
    assert isinstance(back_s, t_tm.TMState)
    assert np.array_equal(back_s.ta_state, np.asarray(js.ta_state))
    for f in jr._fields:
        assert np.array_equal(np.asarray(getattr(back_r, f)),
                              np.asarray(getattr(jr, f))), f
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    tkey = convert.key_from_numpy(np.asarray(key), "cpu")
    assert np.array_equal(convert.to_numpy(tkey).astype(np.uint32),
                          np.asarray(key))
    # Converted state computes what the reference computes.
    xs, _ = j_iris.load()
    assert np.array_equal(
        np.asarray(j_tm.predict_batch(jc, js, jr, jnp.asarray(xs))),
        t_tm.predict_batch(tc, tst, trt, torch.from_numpy(xs)).numpy())


def test_packed_rows_raise():
    """Packed rows route by the word dtype (the port's int32 words, or
    torch.uint32) to the packed entry and predict what the reference's
    packed route predicts; words of the wrong width raise."""
    from repro.kernels import packing as j_packing
    from repro_torch.kernels import packing as t_packing

    (jc, js, jr), (tc, ts, tr) = _machines(5, "cuda")
    xs, _ = j_iris.load()
    words = j_packing.pack_bits_np(xs)                 # [150, 1] np.uint32
    want = np.asarray(j_tm.predict_batch(jc, js, jr, jnp.asarray(words)))
    tw = t_packing.words_from_numpy(words)
    for rows in (tw, tw.view(torch.uint32)):
        assert np.array_equal(t_tm.predict_batch(tc, ts, tr, rows).numpy(),
                              want)
    with pytest.raises((ValueError, RuntimeError)):
        t_tm.predict_batch(tc, ts, tr, torch.zeros(2, 3, dtype=torch.int32))


def test_analyze_and_history_match_reference():
    from repro.core import accuracy as j_acc
    from repro_torch.core import accuracy as t_acc

    (jc, js, jr), (tc, ts, tr) = _machines(4, "cuda")
    xs, ys = j_iris.load()
    js = j_fb.train_epochs(jc, js, jr, jnp.asarray(xs[:30]),
                           jnp.asarray(ys[:30]), jax.random.PRNGKey(1), 2)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    valid = np.arange(len(xs)) % 4 != 0
    for v in (None, valid, np.zeros(len(xs), bool)):
        want = j_acc.analyze(jc, js, jr, jnp.asarray(xs), jnp.asarray(ys),
                             None if v is None else jnp.asarray(v))
        got = t_acc.analyze(tc, ts, tr, torch.from_numpy(xs),
                            torch.from_numpy(ys),
                            None if v is None else torch.from_numpy(v))
        assert _bits(want) == _bits(got.numpy())
    jh = j_acc.make_history(2, 3)
    th = t_acc.make_history(2, 3, device="cpu")
    for i in range(3):                      # the third write saturates
        row = np.asarray([0.25 * i, 0.5, 1.0], np.float32)
        jh = j_acc.record(jh, jnp.asarray(row))
        th = t_acc.record(th, torch.from_numpy(row))
        assert int(jh.idx) == th.idx
        assert np.array_equal(np.asarray(jh.values), th.values.numpy(),
                              equal_nan=True)
