"""The port's cross-validation engine against the reference's, on iris.

The reference engine (``repro.eval.crossval.CrossValRun``) and the port's
(``repro_torch.eval.crossval.CrossValRun``, on the CPU, where every kernel
wrapper runs its plain version) get the same block orderings, s/T grid,
seeds and epochs: O = 3 orderings, a 2 x 2 grid (R = 12, D = 3, so the
replica-to-stream map r % D is exercised with H = 4), 2 epochs.
Validation accuracies and trained TA banks must agree bit for bit.

The mesh cases shard the replica axis over CPU slabs (``Mesh(["cpu"] * 4,
("data",))``: R = 12 in slabs of 3) and hold the sweep and the system
flow bitwise against the port without a mesh and against the JAX
package's sharded runs on four forced host devices (one subprocess for
the module, results through an ``.npz``).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accuracy as j_acc
from repro.core import feedback as j_fb
from repro.core import manager as j_mgr
from repro.core import tm as j_tm
from repro.data import blocks as j_blocks
from repro.eval import crossval as j_cv
from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core import accuracy as t_acc
from repro_torch.core import feedback as t_fb
from repro_torch.core import hpsearch as t_hp
from repro_torch.core import manager as t_mgr
from repro_torch.core import tm as t_tm
from repro_torch.data import blocks as t_blocks
from repro_torch.eval import crossval as t_cv
from repro_torch.launch.mesh import Mesh

FIELDS = dict(n_features=16, max_classes=3, max_clauses=16, n_states=16)
J_CFG = j_tm.TMConfig(**FIELDS, backend="ref")
T_CFGS = [t_tm.TMConfig(**FIELDS, backend=b) for b in ("cuda", "ref")]
S_VALUES, T_VALUES = (1.375, 3.0), (5, 15)
O, EPOCHS, SEED = 3, 2, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread. The suite runs several pytest workers
    at once; torch's intra-op threads on top of them oversubscribe the
    cores, and an MNIST-width flow then ran 20-40x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def osets():
    j_sets, _ = j_blocks.iris_paper_sets(n_orderings=O)
    t_sets, _ = t_blocks.iris_paper_sets(n_orderings=O)
    for a, b in zip(j_sets, t_sets):
        assert np.array_equal(a, b)        # the port's own copy of blocks
    return j_sets


@pytest.fixture(scope="module")
def j_sweep(osets):
    return j_cv.CrossValRun(J_CFG).sweep(
        osets.offline_x, osets.offline_y, osets.validation_x,
        osets.validation_y, S_VALUES, T_VALUES, n_epochs=EPOCHS, seed=SEED)


@pytest.mark.parametrize("cfg", T_CFGS, ids=lambda c: c.backend)
def test_sweep_val_accuracy_bitwise(osets, j_sweep, cfg):
    res = t_cv.CrossValRun(cfg, device="cpu").sweep(
        osets.offline_x, osets.offline_y, osets.validation_x,
        osets.validation_y, S_VALUES, T_VALUES, n_epochs=EPOCHS, seed=SEED)
    assert res.val_accuracy.shape == (2, 2, O) and res.replicas == 4 * O
    assert np.array_equal(_bits(j_sweep.val_accuracy),
                          _bits(res.val_accuracy.numpy()))
    assert np.array_equal(_bits(j_sweep.mean_accuracy),
                          _bits(res.mean_accuracy.numpy()))
    assert res.wall_s > 0 and res.replicas_per_s > 0
    assert np.array_equal(res.s_grid, j_sweep.s_grid)
    assert np.array_equal(res.T_grid, j_sweep.T_grid)


def test_mean_last_matches_jnp_mean_where_torch_mean_does_not():
    """``tm.mean_last`` (sum * f32(1/n), XLA's rule) equals ``jnp.mean``
    bit for bit on [2, 2, 3] grids of k/30 accuracies, the sweep's
    ``mean_accuracy`` at O = 3; ``torch.mean`` misses on some of them."""
    rng = np.random.default_rng(7)
    torch_mean_differs = 0
    for _ in range(50):
        acc = (rng.integers(0, 31, (2, 2, O)) / np.float32(30)).astype(
            np.float32)
        want = _bits(jnp.mean(jnp.asarray(acc), axis=-1))
        assert np.array_equal(want,
                              _bits(t_tm.mean_last(torch.from_numpy(acc))))
        torch_mean_differs += not np.array_equal(
            want, _bits(torch.mean(torch.from_numpy(acc), dim=-1)))
    assert torch_mean_differs > 0


def _mean_last_rel_err(n_orderings: int, n_grids: int = 200):
    """(grids where ``tm.mean_last`` differs from ``jnp.mean``, its largest
    relative difference) over seeded [2, 2, O] grids of k/30 accuracies."""
    rng = np.random.default_rng(0)
    differ, worst = 0, 0.0
    for _ in range(n_grids):
        acc = (rng.integers(0, 31, (2, 2, n_orderings)) / np.float32(30)
               ).astype(np.float32)
        want = np.asarray(jnp.mean(jnp.asarray(acc), axis=-1))
        got = t_tm.mean_last(torch.from_numpy(acc)).numpy()
        differ += not np.array_equal(_bits(want), _bits(got))
        worst = max(worst, float(np.max(np.abs(got - want)
                                        / np.maximum(want, 1e-30))))
    return differ, worst


def test_mean_last_at_the_papers_orderings_within_few_ulp():
    """At O = 120, the paper's sweep, XLA's float sum has no fixed order
    the port can repeat: ``mean_last`` stays within a few ulp of
    ``jnp.mean`` (ROADMAP queue 3 records the measured figure); at O = 8
    it is bitwise."""
    assert _mean_last_rel_err(8) == (0, 0.0)
    _, worst = _mean_last_rel_err(120)
    assert worst <= 4 * float(np.finfo(np.float32).eps)


def test_grid_search_and_best_match_one_cell_loop(osets, j_sweep):
    """hpsearch.grid_search (a thin engine caller) == looping the port's
    per-cell oracle, and ``best`` picks the reference's cell."""
    cfg = T_CFGS[0]
    res = t_hp.grid_search(cfg, S_VALUES, T_VALUES, osets.offline_x,
                           osets.offline_y, osets.validation_x,
                           osets.validation_y, n_epochs=EPOCHS, seed=SEED,
                           device="cpu")
    keys = rnd.split(rnd.PRNGKey(SEED), O)
    for si, s in enumerate(S_VALUES):
        for ti, T in enumerate(T_VALUES):
            for o in range(O):
                acc = t_hp._one_cell(
                    cfg, s, T, torch.from_numpy(osets.offline_x[o]),
                    torch.from_numpy(osets.offline_y[o]),
                    torch.from_numpy(osets.validation_x[o]),
                    torch.from_numpy(osets.validation_y[o]), keys[o],
                    EPOCHS)
                assert _bits(acc.numpy()) == _bits(
                    res.val_accuracy[si, ti, o].numpy())
    from repro.core import hpsearch as j_hp

    j_grid = j_hp.GridResult(j_sweep.s_grid, j_sweep.T_grid,
                             j_sweep.val_accuracy, j_sweep.mean_accuracy)
    assert t_hp.best(res)[:2] == j_hp.best(j_grid)[:2]


def test_grid_layout_matches_reference():
    for s_vals, T_vals, n in (((1.375, 3.0), (5, 15), 3),
                              ((1.0, 2.0, 4.0), (7,), 5), ((2.5,), (3, 9), 1)):
        js, jT = j_cv.grid_layout(s_vals, T_vals, n)
        ts, tT = t_cv.grid_layout(s_vals, T_vals, n)
        assert ts.dtype == torch.float32 and tT.dtype == torch.int32
        assert np.array_equal(_bits(js), _bits(ts.numpy()))
        assert np.array_equal(np.asarray(jT), tT.numpy())


@pytest.mark.parametrize("cfg", T_CFGS, ids=lambda c: c.backend)
def test_trained_banks_bitwise(osets, cfg):
    """train_epochs_replicated over the sweep layout, with a training mask:
    the [R, C, J, L] banks and the per-step activity."""
    s_rep, T_rep = j_cv.grid_layout(S_VALUES, T_VALUES, O)
    R = s_rep.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(SEED), O)
    valid = np.arange(osets.offline_x.shape[1])[None] < np.array(
        [[20], [30], [11]])
    j_rt = j_tm.init_runtime(J_CFG)._replace(s=s_rep, T=T_rep)
    j_state = j_fb.train_epochs_replicated(
        J_CFG, j_cv.replicate_state(J_CFG, R), j_rt,
        jnp.asarray(osets.offline_x), jnp.asarray(osets.offline_y), keys,
        EPOCHS, valid=jnp.asarray(valid))
    _, j_act = j_fb.train_datapoints_replicated(
        J_CFG, j_state, j_rt, jnp.asarray(osets.validation_x),
        jnp.asarray(osets.validation_y), keys)

    s_t, T_t = t_cv.grid_layout(S_VALUES, T_VALUES, O)
    t_rt = t_tm.init_runtime(cfg, device="cpu")._replace(s=s_t, T=T_t)
    t_keys = convert.key_from_numpy(keys, "cpu")
    t_state = t_fb.train_epochs_replicated(
        cfg, t_cv.replicate_state(cfg, R, "cpu"), t_rt,
        torch.from_numpy(osets.offline_x), torch.from_numpy(osets.offline_y),
        t_keys, EPOCHS, valid=torch.from_numpy(valid))
    assert np.array_equal(np.asarray(j_state.ta_state),
                          t_state.ta_state.numpy())
    _, t_act = t_fb.train_datapoints_replicated(
        cfg, t_state, t_rt, torch.from_numpy(osets.validation_x),
        torch.from_numpy(osets.validation_y), t_keys)
    # Per-step activity is an exact count times f32(1 / numel).
    assert np.array_equal(_bits(j_act), _bits(t_act.numpy()))


def test_replicate_state_matches_init():
    st = t_cv.replicate_state(T_CFGS[0], 5, "cpu")
    one = t_tm.init_state(T_CFGS[0], device="cpu").ta_state
    assert st.ta_state.shape == (5,) + one.shape
    assert all(torch.equal(st.ta_state[r], one) for r in range(5))


def _trained_state(osets):
    """An [R = 2 * O] bank trained on the sweep layout (port, CPU)."""
    cfg = T_CFGS[1]
    s_rep, T_rep = t_cv.grid_layout((1.375, 3.0), (15,), O)
    rt = t_tm.init_runtime(cfg, device="cpu")._replace(s=s_rep, T=T_rep)
    st = t_fb.train_epochs_replicated(
        cfg, t_cv.replicate_state(cfg, 2 * O, "cpu"), rt,
        torch.from_numpy(osets.offline_x), torch.from_numpy(osets.offline_y),
        rnd.split(rnd.PRNGKey(1), O), 1)
    return cfg, st, rt


def test_analyze_sets_replicated_equals_separate_calls(osets):
    """One fused three-set analysis == three analyze_replicated calls, and
    both equal the reference's, with and without validity masks."""
    cfg, st, rt = _trained_state(osets)
    rng = np.random.default_rng(3)
    sets = []
    for x, y in ((osets.offline_x, osets.offline_y),
                 (osets.validation_x, osets.validation_y),
                 (osets.online_x, osets.online_y)):
        v = rng.random(y.shape) < 0.7
        sets.append((x, y, v))
    sets[1] = (sets[1][0], sets[1][1], None)
    t_sets = [(torch.from_numpy(x), torch.from_numpy(y),
               None if v is None else torch.from_numpy(v))
              for x, y, v in sets]
    fused = t_acc.analyze_sets_replicated(cfg, st, rt, t_sets)
    apart = torch.stack([t_acc.analyze_replicated(cfg, st, rt, *s)
                         for s in t_sets], dim=-1)
    assert fused.shape == (2 * O, 3)
    assert np.array_equal(_bits(fused.numpy()), _bits(apart.numpy()))
    j_rt = j_tm.init_runtime(J_CFG)._replace(s=jnp.asarray(rt.s.numpy()),
                                             T=jnp.asarray(rt.T.numpy()))
    j_st = j_tm.TMState(jnp.asarray(st.ta_state.numpy()))
    want = j_acc.analyze_sets_replicated(
        J_CFG, j_st, j_rt,
        [(jnp.asarray(x), jnp.asarray(y), None if v is None
          else jnp.asarray(v)) for x, y, v in sets])
    assert np.array_equal(_bits(want), _bits(fused.numpy()))
    # And replica r of the fused pass is analyze() on ordering r % O.
    for r in range(2 * O):
        one = t_tm.TMState(st.ta_state[r])
        rt1 = rt._replace(s=rt.s[r], T=rt.T[r])
        x, y, v = (t[r % O] for t in t_sets[0])
        acc = t_acc.analyze(cfg, one, rt1, x, y, valid=v)
        assert _bits(acc.numpy()) == _bits(fused[r, 0].numpy())


def _sets(osets, offline_limit=20):
    Oo, n_off = osets.offline_y.shape
    train_valid = np.ones((Oo, n_off), dtype=bool)
    train_valid[:, offline_limit:] = False
    return j_mgr.Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((Oo, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=train_valid)


@pytest.mark.parametrize("cfg", T_CFGS, ids=lambda c: c.backend)
def test_system_matches_reference(osets, cfg):
    """CrossValRun.system: accuracies and final banks bitwise; the
    per-cycle activity is a float32 mean of non-0/1 values, which XLA
    reduces in an order no fixed sum reproduces, so it is held to
    rtol = 2e-6."""
    sys_cfg = dataclasses.replace(j_mgr.SystemConfig(), n_offline_epochs=2,
                                  n_online_cycles=3)
    sets = _sets(osets)
    keys = jax.random.split(jax.random.PRNGKey(9), O)
    j_rt = j_tm.init_runtime(J_CFG, s=1.375, T=15)
    j_res = j_cv.CrossValRun(J_CFG).system(
        sys_cfg, jax.vmap(lambda _: j_tm.init_state(J_CFG))(jnp.arange(O)),
        j_rt, jax.tree.map(jnp.asarray, sets),
        j_mgr.make_schedule(online_s=1.0), keys)

    t_res = t_cv.CrossValRun(cfg, device="cpu").system(
        t_mgr.SystemConfig(2, 3), t_cv.replicate_state(cfg, O, "cpu"),
        t_tm.init_runtime(cfg, s=1.375, T=15, device="cpu"),
        convert.sets_from_numpy(sets, "cpu"),
        t_mgr.make_schedule(online_s=1.0), convert.key_from_numpy(keys, "cpu"))
    assert t_res.replicas == O and t_res.wall_s > 0
    assert t_res.accuracies.shape == (O, 4, 3)
    assert np.array_equal(_bits(j_res.accuracies),
                          _bits(t_res.accuracies.numpy()))
    assert np.array_equal(np.asarray(j_res.state.ta_state),
                          t_res.state.ta_state.numpy())
    np.testing.assert_allclose(t_res.activity.numpy(),
                               np.asarray(j_res.activity), rtol=2e-6, atol=0)


def test_predict_batch_replicated_matches_reference(osets):
    """The replica-first inference entry (K4 through the contract) on a
    trained [R = 2 * O] bank with a class masked out, and its packed
    route (K6): the same rows as words predict the same classes."""
    cfg, st, rt = _trained_state(osets)
    rt = rt._replace(class_mask=torch.tensor([True, False, True]))
    xs = osets.online_x                                     # [O, 60, 16]
    got = t_tm.predict_batch_replicated(cfg, st, rt, torch.from_numpy(xs))
    j_rt = j_tm.init_runtime(J_CFG)._replace(
        s=jnp.asarray(rt.s.numpy()), T=jnp.asarray(rt.T.numpy()),
        class_mask=jnp.asarray([True, False, True]))
    want = j_tm.predict_batch_replicated(
        J_CFG, j_tm.TMState(jnp.asarray(st.ta_state.numpy())), j_rt,
        jnp.asarray(xs))
    assert got.shape == (2 * O, 60) and not bool((got == 1).any())
    assert np.array_equal(np.asarray(want), got.numpy())
    from repro_torch.kernels import packing

    words = packing.pack_bits(torch.from_numpy(xs))         # [O, 60, 1]
    assert torch.equal(t_tm.predict_batch_replicated(cfg, st, rt, words), got)


# ---------------------------------------------------------------------------
# The replica-axis mesh
# ---------------------------------------------------------------------------

JAX_MESH_SCRIPT = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[2])
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    assert len(jax.devices()) == 4, jax.devices()
    import test_torch_crossval as tc
    from repro.data import blocks
    from repro.eval import crossval as cv

    mesh = Mesh(np.array(jax.devices()), ("data",))
    osets, _ = blocks.iris_paper_sets(n_orderings=tc.O)
    eng = cv.CrossValRun(tc.J_CFG, mesh=mesh)
    res = eng.sweep(osets.offline_x, osets.offline_y, osets.validation_x,
                    osets.validation_y, tc.S_VALUES, tc.T_VALUES,
                    n_epochs=tc.EPOCHS, seed=tc.SEED)
    out = {"val": np.asarray(res.val_accuracy),
           "mean": np.asarray(res.mean_accuracy)}
    sys_cfg, states, rt, sets, sched, keys = tc._system_args_jax(osets)
    res = eng.system(sys_cfg, states, rt, sets, sched, keys)
    out.update(sys_acc=np.asarray(res.accuracies),
               sys_ta=np.asarray(res.state.ta_state),
               sys_act=np.asarray(res.activity))
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def _system_args_jax(osets):
    sets = _sets(osets)
    keys = jax.random.split(jax.random.PRNGKey(9), O)
    return (j_mgr.SystemConfig(2, 3),
            jax.vmap(lambda _: j_tm.init_state(J_CFG))(jnp.arange(O)),
            j_tm.init_runtime(J_CFG, s=1.375, T=15),
            jax.tree.map(jnp.asarray, sets),
            j_mgr.make_schedule(online_s=1.0), keys)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded sweep and system flow on four forced host
    devices (one subprocess for the module)."""
    tests = pathlib.Path(__file__).resolve().parent
    path = tmp_path_factory.mktemp("jax_mesh") / "crossval.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tests.parent / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", JAX_MESH_SCRIPT, str(path), str(tests)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("cfg", T_CFGS, ids=lambda c: c.backend)
def test_sweep_with_mesh_sharding(osets, jax_sharded, cfg):
    """A sweep sharded over four CPU slabs (R = 12, slabs of 3 = O) is
    bitwise the unsharded sweep and the JAX package's sharded one."""
    args = (osets.offline_x, osets.offline_y, osets.validation_x,
            osets.validation_y, S_VALUES, T_VALUES)
    kw = dict(n_epochs=EPOCHS, seed=SEED)
    base = t_cv.CrossValRun(cfg, device="cpu").sweep(*args, **kw)
    eng = t_cv.CrossValRun(cfg, mesh=Mesh(["cpu"] * 4, ("data",)))
    assert [s.hi - s.lo for s in eng._put(torch.zeros(12), 12)] == [3] * 4
    res = eng.sweep(*args, **kw)
    for got, name in ((res.val_accuracy, "val"),
                      (res.mean_accuracy, "mean")):
        assert np.array_equal(_bits(jax_sharded[name]), _bits(got.numpy()))
    assert torch.equal(base.val_accuracy, res.val_accuracy)
    assert torch.equal(base.mean_accuracy, res.mean_accuracy)


@pytest.mark.parametrize("n_dev,n_slabs", [(4, 1), (3, 3)],
                         ids=["not_dividing_one_slab", "three_slabs"])
def test_system_with_mesh(osets, jax_sharded, n_dev, n_slabs):
    """CrossValRun(mesh).system over the O = 3 orderings: on four devices
    the ordering axis does not divide and runs as one slab (the
    reference replicates it), on three it runs in three slabs of one;
    both are bitwise the unsharded flow, and the accuracies and banks the
    JAX package's sharded flow (activity within the XLA mean's
    rounding)."""
    cfg = T_CFGS[0]
    mesh = Mesh(["cpu"] * n_dev, ("data",))
    sets = convert.sets_from_numpy(_sets(osets), "cpu")
    keys = rnd.split(rnd.PRNGKey(9, "cpu"), O)
    args = (t_mgr.SystemConfig(2, 3), t_cv.replicate_state(cfg, O, "cpu"),
            t_tm.init_runtime(cfg, s=1.375, T=15, device="cpu"), sets,
            t_mgr.make_schedule(online_s=1.0), keys)
    eng = t_cv.CrossValRun(cfg, mesh=mesh)
    assert len(eng._put(torch.zeros(O), O)) == n_slabs
    base = t_cv.CrossValRun(cfg, device="cpu").system(*args)
    res = eng.system(*args)
    assert torch.equal(base.accuracies, res.accuracies)
    assert torch.equal(base.state.ta_state, res.state.ta_state)
    assert torch.equal(base.activity, res.activity)
    assert np.array_equal(_bits(jax_sharded["sys_acc"]),
                          _bits(res.accuracies.numpy()))
    assert np.array_equal(jax_sharded["sys_ta"], res.state.ta_state.numpy())
    np.testing.assert_allclose(res.activity.numpy(), jax_sharded["sys_act"],
                               rtol=2e-6, atol=0)
