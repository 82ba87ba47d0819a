"""The port's twin of ``tests/test_tm_core.py``: the TM behaviours beyond
parity (the empty-clause convention, over-provisioned clauses and
classes, stuck-at faults, runtime s/T, masked rows), each checked on the
port as the reference's test checks them, and held to the reference's
own result on the same inputs and keys, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as J
from repro.core import faults as j_faults
from repro.core import tm as j_tm
from repro.data import iris
from repro_torch import convert
from repro_torch import core as P
from repro_torch.core import faults as p_faults
from repro_torch.core import tm as p_tm

CFG = dict(n_features=16, max_classes=3, max_clauses=16, n_states=50)


def _cfgs(**kw):
    d = dict(CFG, **kw)
    return J.TMConfig(**d), P.TMConfig(backend="ref", **d)


def _key(seed):
    return jax.random.PRNGKey(seed), convert.key_from_numpy(
        np.asarray(jax.random.PRNGKey(seed)), "cpu")


def _states(seed):
    jc, pc = _cfgs()
    jk, pk = _key(seed)
    js, ps = J.init_state(jc, jk), P.init_state(pc, pk, device="cpu")
    assert np.array_equal(np.asarray(js.ta_state), ps.ta_state.numpy())
    return (jc, js), (pc, ps)


def _rt(jc, pc, **kw):
    return J.init_runtime(jc, **kw), P.init_runtime(pc, device="cpu", **kw)


def test_init_state_boundary():
    jc, pc = _cfgs()
    st = P.init_state(pc, device="cpu")
    assert st.ta_state.shape == (3, 16, 32)
    assert bool((st.ta_state == pc.n_states).all())
    assert np.array_equal(np.asarray(J.init_state(jc).ta_state),
                          st.ta_state.numpy())
    (_, js), (_, ps) = _states(0)
    v = ps.ta_state.numpy()
    assert set(np.unique(v)) <= {pc.n_states, pc.n_states + 1}
    assert np.array_equal(np.asarray(js.ta_state), v)


def test_forward_shapes_and_empty_convention():
    jc, pc = _cfgs()
    jr, pr = _rt(jc, pc)
    js, ps = J.init_state(jc), P.init_state(pc, device="cpu")
    x = np.zeros((16,), dtype=bool)
    out = {}
    for training in (True, False):
        cl, votes = P.forward(pc, ps, pr, torch.from_numpy(x),
                              training=training)
        jcl, jv = J.forward(jc, js, jr, jnp.asarray(x), training=training)
        assert np.array_equal(cl.numpy(), np.asarray(jcl))
        assert np.array_equal(votes.numpy(), np.asarray(jv))
        out[training] = (cl, votes)
    cl_tr, votes_tr = out[True]
    cl_inf, _ = out[False]
    assert cl_tr.shape == (3, 16) and votes_tr.shape == (3,)
    # all-exclude init: every clause empty, 1 in training, 0 in inference
    assert bool(cl_tr.all()) and not bool(cl_inf.any())
    assert int(votes_tr.abs().sum()) == 0  # polarities cancel (8+, 8-)


def test_clause_mask_gates_votes():
    """Over-provisioned clauses (§3.1.1) do not vote until enabled."""
    (jc, js), (pc, ps) = _states(1)
    jr_full, pr_full = _rt(jc, pc)
    jr_half, pr_half = _rt(jc, pc, n_active_clauses=8)
    x = np.random.default_rng(0).random(16) < 0.5
    cl_full, _ = P.forward(pc, ps, pr_full, torch.from_numpy(x),
                           training=True)
    cl_half, _ = P.forward(pc, ps, pr_half, torch.from_numpy(x),
                           training=True)
    assert not bool(cl_half[:, 8:].any())
    assert torch.equal(cl_full[:, :8], cl_half[:, :8])
    want, _ = J.forward(jc, js, jr_half, jnp.asarray(x), training=True)
    assert np.array_equal(cl_half.numpy(), np.asarray(want))


def test_class_mask_excludes_from_prediction():
    (jc, js), (pc, ps) = _states(2)
    jr, pr = _rt(jc, pc, n_active_classes=2)
    xs = np.random.default_rng(1).random((20, 16)) < 0.5
    preds = P.predict_batch(pc, ps, pr, torch.from_numpy(xs)).numpy()
    assert preds.max() < 2  # class 2 is over-provisioned, never predicted
    assert np.array_equal(preds, np.asarray(
        J.predict_batch(jc, js, jr, jnp.asarray(xs))))


def test_fault_masks_force_actions():
    """§3.1.2: AND = 0 forces action 0; OR = 1 forces action 1."""
    (jc, js), (pc, ps) = _states(3)
    jr, pr = _rt(jc, pc)
    pr0 = pr._replace(ta_and_mask=torch.zeros_like(pr.ta_and_mask))
    assert not bool(p_tm.ta_actions(pc, ps, pr0).any())
    pr1 = pr._replace(ta_or_mask=torch.ones_like(pr.ta_or_mask))
    assert bool(p_tm.ta_actions(pc, ps, pr1).all())
    # a mixed pattern equals the reference's actions
    and_m, or_m = p_faults.even_spread_stuck_at(pc, 0.2, 0)
    _, or_m = p_faults.even_spread_stuck_at(pc, 0.1, 1, offset=3)
    got = p_tm.ta_actions(pc, ps, pr._replace(
        ta_and_mask=torch.from_numpy(and_m),
        ta_or_mask=torch.from_numpy(or_m)))
    want = j_tm.ta_actions(jc, js, jr._replace(
        ta_and_mask=jnp.asarray(and_m), ta_or_mask=jnp.asarray(or_m)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_even_spread_fault_fraction():
    jc, pc = _cfgs()
    and_m, or_m = p_faults.even_spread_stuck_at(pc, 0.2, 0)
    assert abs((1.0 - and_m.mean()) - 0.2) < 0.01
    assert or_m.sum() == 0
    and_m1, or_m1 = p_faults.even_spread_stuck_at(pc, 0.2, 1)
    assert and_m1.all() and abs(or_m1.mean() - 0.2) < 0.01
    for v in (0, 1):
        for got, want in zip(p_faults.even_spread_stuck_at(pc, 0.2, v),
                             j_faults.even_spread_stuck_at(jc, 0.2, v)):
            assert np.array_equal(got, np.asarray(want))


def test_runtime_s_T_change_no_rebuild():
    """s and T are runtime ports: one machine, one config, a step at each
    setting (the reference's jitted step does not retrace for them); each
    step equals the reference's at the same setting."""
    (jc, js), (pc, ps) = _states(0)
    jr, pr = _rt(jc, pc)
    xs, ys = iris.load()
    jk, pk = _key(0)
    traces = 0

    @jax.jit
    def step(st, rt, x, y, k):
        nonlocal traces
        traces += 1
        return J.train_step(jc, st, rt, x, y, k)

    for s, T in ((3.9, 15), (2.5, 7)):
        jrt = jr._replace(s=jnp.float32(s), T=jnp.int32(T))
        prt = pr._replace(s=torch.tensor(s, dtype=torch.float32),
                          T=torch.tensor(T, dtype=torch.int32))
        want, _ = step(js, jrt, jnp.asarray(xs[0]), jnp.asarray(ys[0]), jk)
        got, _ = P.train_step(pc, ps, prt, torch.from_numpy(xs[0]),
                              torch.tensor(ys[0]), pk)
        assert np.array_equal(got.ta_state.numpy(),
                              np.asarray(want.ta_state))
    assert traces == 1


def test_training_learns_iris():
    """10 epochs on all of iris at s = 3.0, T = 5 (T = 15 cannot be reached
    by a 16-clause vote, so the machine would never anneal): the port's
    bank is the reference's bit for bit, and it fits the training set
    above 0.9, the reference's bound."""
    from repro.core import accuracy as j_acc
    from repro_torch.core import accuracy as p_acc

    jc, pc = _cfgs()
    jr, pr = _rt(jc, pc, s=3.0, T=5)
    xs, ys = iris.load()
    jk, pk = _key(0)
    want = J.train_epochs(jc, J.init_state(jc), jr, jnp.asarray(xs),
                          jnp.asarray(ys), jk, 10)
    got = P.train_epochs(pc, P.init_state(pc, device="cpu"), pr,
                         torch.from_numpy(xs), torch.from_numpy(ys), pk, 10)
    assert np.array_equal(got.ta_state.numpy(), np.asarray(want.ta_state))
    acc = float(p_acc.analyze(pc, got, pr, torch.from_numpy(xs),
                              torch.from_numpy(ys)))
    assert acc == float(j_acc.analyze(jc, want, jr, jnp.asarray(xs),
                                      jnp.asarray(ys)))
    assert acc > 0.9, f"train accuracy {acc} too low"


def test_valid_mask_rows_are_skipped():
    """Masked rows leave the state untouched (class filter substrate)."""
    jc, pc = _cfgs()
    jr, pr = _rt(jc, pc, s=3.0, T=15)
    (_, js), (_, ps) = _states(5)
    xs, ys = iris.load()
    _, pk = _key(1)
    st1, aux = P.train_datapoints(pc, ps, pr, torch.from_numpy(xs[:10]),
                                  torch.from_numpy(ys[:10]), pk,
                                  valid=torch.zeros(10, dtype=torch.bool))
    assert torch.equal(st1.ta_state, ps.ta_state)
    assert not bool(aux.correct.any()) and not bool(aux.activity.any())
