"""The port's training substrate against the JAX package's, on the CPU:
the twins of tests/test_train_substrate.py (optimizer, schedule, clip,
compression, the fault-tolerant loop, checkpoints) plus parity.

* ``compress_grads`` (dequantised gradients, residuals), the step counter,
  checkpoint leaves and the synthetic batches: bitwise.
* ``apply`` from equal inputs, the clip inactive: moments bitwise, SGD
  parameters bitwise, AdamW parameters within 1 ulp (XLA's and torch's
  float32 ``pow`` may differ in the last bit of ``b ** t``). The learning
  rate within 1 ulp of ``lr`` (float32 ``cos``). The tests print their
  worst cases (0 ulp for the parameters here, 1 for the cosine rate).
* Float sums over leaves (the global norm, the compression error) add in
  another order: within 1e-6 relative (printed: 4 ulp of the norm over
  float32 gradients, 11 over bfloat16 ones). With the clip active its
  scale carries that: the clipped float32 gradients are held within 4
  ulp of each leaf's max (printed: 4).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import ShapeConfig as RShape
from repro.data import synthetic as RSyn
from repro.distributed import collectives as RC
from repro.models import params as RP
from repro.models import transformer as RT
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import configs, convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic
from repro_torch.distributed import collectives as C
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as TS
from repro_torch.train.train_step import TrainState

DENSE = ["granite_8b", "gemma3_1b", "phi3_medium_14b", "qwen25_14b",
         "musicgen_medium"]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(
            np.float32)), "b": torch.zeros(4)},
        "head": torch.from_numpy(rng.standard_normal((4, 2)).astype(
            np.float32)),
    }


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((40, 30)) * scale).astype(
        np.float32)}, "b": (rng.standard_normal(7) * scale).astype(np.float32)}


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).ravel().view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).ravel().view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _pairs(jtree, ttree):
    """(reference leaf, port leaf) in the reference's leaf order."""
    for path, a in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        node = ttree
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        yield "/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in
                       path), np.asarray(a), node


# -- twins of tests/test_train_substrate.py --------------------------------


def test_adamw_reduces_quadratic():
    params = _params()
    target = {"a": {"w": torch.ones(8, 4), "b": torch.ones(4)},
              "head": torch.ones(4, 2)}
    oc = opt.OptConfig(lr=0.05, warmup_steps=1, total_steps=200,
                       weight_decay=0.0)
    state = opt.init(oc, params)

    def loss(p):
        return sum(((a - b) ** 2).sum() for a, b in zip(
            [p["a"]["w"], p["a"]["b"], p["head"]],
            [target["a"]["w"], target["a"]["b"], target["head"]]))

    l0 = float(loss(params))
    for _ in range(100):
        leaves = [params["a"]["w"], params["a"]["b"], params["head"]]
        for x in leaves:
            x.requires_grad_()
        g = torch.autograd.grad(loss(params), leaves)
        grads = {"a": {"w": g[0], "b": g[1]}, "head": g[2]}
        params = {"a": {"w": params["a"]["w"].detach(),
                        "b": params["a"]["b"].detach()},
                  "head": params["head"].detach()}
        params, state, m = opt.apply(oc, state, params, grads)
    assert float(loss(params)) < 0.2 * l0
    assert int(state.step) == 100 and state.step.dtype == torch.int32


def test_schedule_warmup_and_cosine():
    oc = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110)
    lrs = [float(opt.schedule_lr(oc, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 9, 10, 110)]
    assert lrs[0] < 0.2 and abs(lrs[2] - 1.0) < 0.01
    assert lrs[3] < 0.01


def test_clip_by_global_norm():
    clipped, gn = opt.clip_by_global_norm({"w": torch.full((4,), 10.0)}, 1.0)
    assert abs(float(gn) - 20.0) < 1e-3
    assert abs(float(torch.linalg.norm(clipped["w"])) - 1.0) < 1e-3


def test_grad_compression_error_feedback():
    g = {"w": torch.from_numpy((np.random.default_rng(0).standard_normal(64)
                                * 1e-3).astype(np.float32))}
    state = C.init_state(g)
    total = torch.zeros_like(g["w"])
    for _ in range(50):
        dq, state, _ = C.compress_grads(g, state)
        total = total + dq["w"]
    err = float((total - 50 * g["w"]).abs().max())
    assert err < 2 * float(g["w"].abs().max())


def test_grad_compression_int8_range():
    q, scale = C._quantize_int8(torch.tensor([[1000.0, -1000.0, 0.5]]))
    assert q.dtype == torch.int8
    assert int(q.max()) <= 127 and int(q.min()) >= -127


def test_checkpoint_keep_k_and_latest(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, {"x": torch.arange(4)}, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and ckpt.latest_step(str(tmp_path)) == 4


def _toy_state():
    params = {"w": torch.ones(2)}
    return TrainState(params=params, opt=opt.init(opt.OptConfig(), params),
                      compress=None)


def test_loop_nan_fault_triggers_restore(tmp_path):
    """Watchdog: consecutive NaN steps roll back to the last checkpoint."""
    lc = loop_mod.LoopConfig(total_steps=8, checkpoint_every=2,
                             checkpoint_dir=str(tmp_path), max_faults=2)
    calls = {"n": 0}

    def step_fn(st, batch):
        calls["n"] += 1
        loss = torch.tensor(np.nan if calls["n"] in (5, 6) else 1.0)
        new_opt = st.opt._replace(step=st.opt.step + 1)
        return TrainState(st.params, new_opt, None), {"loss": loss}

    data = iter(lambda: {"x": torch.zeros(())}, None)
    state, report = loop_mod.run(lc, _toy_state(), step_fn, data,
                                 log=lambda s: None)
    assert report.restores == 1
    assert [e[1] for e in report.fault_events] == ["nan_loss", "nan_loss"]
    assert state.opt.step.dtype == torch.int32


def test_loop_straggler_detection(tmp_path):
    import time as _t

    lc = loop_mod.LoopConfig(total_steps=6, checkpoint_every=100,
                             checkpoint_dir=str(tmp_path),
                             straggler_factor=3.0)
    calls = {"n": 0}

    def step_fn(st, batch):
        calls["n"] += 1
        _t.sleep(0.25 if calls["n"] == 5 else 0.01)
        new_opt = st.opt._replace(step=st.opt.step + 1)
        return TrainState(st.params, new_opt, None), {"loss": torch.tensor(1.)}

    data = iter(lambda: {}, None)
    _, report = loop_mod.run(lc, _toy_state(), step_fn, data,
                             log=lambda s: None)
    assert len(report.straggler_steps) >= 1


def test_loop_resume_continues_bitwise(tmp_path):
    """Checkpoint every 2 steps, stop after 2, resume from the latest and
    run to 4 (the data replayed from the resumed step): the state equals
    an uninterrupted 4-step run's, bit for bit; keep-1 keeps one step."""
    cfg = configs.get_smoke_config("granite_8b")
    tc = TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1),
                        grad_compress=True)
    shape = ShapeConfig("t", 16, 2, "train")

    def fresh():
        from repro_torch.models import params as P
        from repro_torch.models import transformer

        gen = torch.Generator().manual_seed(3)
        prm = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
        return TS.init_state(tc, prm)

    def step_fn(s, b):
        return TS.train_step(cfg, tc, s, b, donate=True)

    def run(total, d, start=0, state=None):
        lc = loop_mod.LoopConfig(total_steps=total, checkpoint_every=2,
                                 checkpoint_dir=str(d), keep=1)
        state = loop_mod.resume_or_init(lc, fresh() if state is None
                                        else state)
        return loop_mod.run(lc, state, step_fn, synthetic.token_batches(
            cfg, shape, seed=5, start_step=start), log=lambda s: None)

    want, rep = run(4, tmp_path / "a")
    assert rep.steps_run == 4
    run(2, tmp_path / "b")
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    got, rep = run(4, tmp_path / "b", start=2)
    assert rep.steps_run == 2
    assert len(os.listdir(tmp_path / "b")) == 2      # step_4 + LATEST
    a, b = (convert.lm_train_state_to_numpy(s) for s in (want, got))
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(a)[0],
            jax.tree_util.tree_flatten_with_path(b)[0]):
        assert x.dtype == y.dtype and np.array_equal(x, y), path


class _Clock:
    """A stand-in for the loop's ``time`` module: every step takes 1 s,
    the steps in ``slow`` 100 s."""

    def __init__(self, slow):
        self.t, self.calls, self.slow = 0.0, 0, slow

    def monotonic(self):
        self.calls += 1
        if self.calls % 2 == 0:              # a step's second reading
            self.t += 100.0 if self.calls // 2 - 1 in self.slow else 1.0
        return self.t


@pytest.mark.parametrize("reason", ["deadline", "nan_loss"])
def test_loop_fault_under_donation_restores(tmp_path, monkeypatch, reason):
    """A donating step has already written its update (and its step count)
    into the state when the watchdog flags it, so the loop restores the
    last checkpoint at once: the run ends in the very state of the
    non-donating run, which skips the bad update, bit for bit. Before the
    first checkpoint there is nothing to restore, and the loop raises."""
    cfg = configs.get_smoke_config("granite_8b")
    tc = TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1))
    shape = ShapeConfig("t", 16, 2, "train")

    def run(donate, d, every=2, bad=2):
        from repro_torch.models import params as P
        from repro_torch.models import transformer

        calls = []

        def step_fn(s, b):
            s, m = TS.train_step(cfg, tc, s, b, donate=donate)
            calls.append(len(calls))
            if reason == "nan_loss" and calls[-1] == bad:
                m["loss"] = torch.tensor(float("nan"))
            return s, m

        monkeypatch.setattr(loop_mod, "time", _Clock(
            {bad} if reason == "deadline" else set()))
        lc = loop_mod.LoopConfig(total_steps=4, checkpoint_every=every,
                                 checkpoint_dir=str(d), step_deadline_s=10.0)
        gen = torch.Generator().manual_seed(3)
        prm = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
        return loop_mod.run(lc, TS.init_state(tc, prm), step_fn,
                            synthetic.token_batches(cfg, shape, seed=5),
                            log=lambda s: None)

    want, rep_w = run(False, tmp_path / "skip")
    got, rep_g = run(True, tmp_path / "donate")
    assert [e[:2] for e in rep_g.fault_events] == [(2, reason)]
    assert rep_w.fault_events == rep_g.fault_events
    assert (rep_w.restores, rep_g.restores) == (0, 1)
    assert rep_w.steps_run == rep_g.steps_run == 3
    assert rep_w.losses == rep_g.losses
    assert int(got.opt.step) == 3
    a, b = (convert.lm_train_state_to_numpy(s) for s in (want, got))
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(a)[0],
            jax.tree_util.tree_flatten_with_path(b)[0]):
        assert x.dtype == y.dtype and np.array_equal(x, y), path
    with pytest.raises(FileNotFoundError):
        run(True, tmp_path / "none", every=100, bad=0)


# -- parity with the reference ---------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    worst = 0.0
    for wu, tot in ((1, 10), (10, 110), (100, 10_000), (7, 3)):
        for lr in (0.37, 1e-3, 3e-4):
            jo = RO.OptConfig(schedule=schedule, lr=lr, warmup_steps=wu,
                              total_steps=tot)
            to = opt.OptConfig(schedule=schedule, lr=lr, warmup_steps=wu,
                               total_steps=tot)
            for s in range(0, tot + 20, max(1, tot // 200)):
                a = np.float32(RO.schedule_lr(jo, jnp.int32(s)))
                b = opt.schedule_lr(to, torch.tensor(s, dtype=torch.int32))
                assert b.dtype == torch.float32
                worst = max(worst, abs(float(a) - b.item())
                            / np.spacing(np.float32(lr)))
    print(f"{schedule}: within {worst} ulp of lr")
    assert worst <= 1.0, worst
    if schedule != "cosine":
        assert worst == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_reference(dtype):
    rng = np.random.default_rng(1)
    norm_ulps, worst = 0, 0.0
    for _ in range(20):
        g = _np_tree(int(rng.integers(1 << 30)), 10.0 ** rng.uniform(-2, 2))
        jg = jax.tree.map(lambda x: jnp.asarray(x, dtype), g)
        tg = jax.tree.map(lambda x: torch.from_numpy(x).to(
            getattr(torch, dtype)), g)
        a, an = RO.clip_by_global_norm(jg, 1.0)
        b, bn = opt.clip_by_global_norm(tg, 1.0)
        norm_ulps = max(norm_ulps, _ulps(an, bn.numpy()).max())
        assert abs(float(an) - bn.item()) <= 1e-6 * float(an)
        for path, x, y in _pairs(a, b):
            assert y.dtype == getattr(torch, dtype), path
            x, y = x.astype(np.float32), y.float().numpy()
            err = np.max(np.abs(x - y)) / np.spacing(np.max(np.abs(x)))
            worst = max(worst, err)
            # bfloat16: the clipped values round to 8 bits, so an ulp of
            # the float32 scale moves them by at most one bfloat16 ulp
            # (2 ** 16 float32 ulps).
            limit = 4 if dtype == "float32" else 2 ** 16
            assert err <= limit, (path, err)
    print(f"{dtype}: norm within {norm_ulps} ulp, clipped gradients within "
          f"{worst} ulp of each leaf's max")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_apply_matches_reference(name, schedule, moments):
    """One update from equal inputs, gradients under the clip norm."""
    rng = np.random.default_rng(2)
    kw = dict(name=name, schedule=schedule, lr=1e-2, warmup_steps=3,
              total_steps=40, clip_norm=1e6, moment_dtype=moments)
    jo, to = RO.OptConfig(**kw), opt.OptConfig(**kw)
    mdt = getattr(torch, moments)
    worst = 0
    for trial in range(10):
        p = _np_tree(10 * trial)
        g = _np_tree(10 * trial + 1, 10.0 ** rng.uniform(-4, 0))
        m = _np_tree(10 * trial + 2, 1e-2)
        v = jax.tree.map(lambda x: np.abs(x) * 1e-2, _np_tree(10 * trial + 3))
        step = int(rng.integers(0, 45))
        js = RO.OptState(jnp.int32(step),
                         jax.tree.map(lambda x: jnp.asarray(x, moments), m),
                         jax.tree.map(lambda x: jnp.asarray(x, moments), v))
        ts = opt.OptState(torch.tensor(step, dtype=torch.int32),
                          jax.tree.map(lambda x: torch.tensor(x).to(mdt), m),
                          jax.tree.map(lambda x: torch.tensor(x).to(mdt), v))
        jp, js2, jm = RO.apply(jo, js, jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, g))
        # donate writes into the port's tensors: copies, never views of
        # arrays the reference may still read (its dispatch is async)
        tp, ts2, tm = opt.apply(to, ts, jax.tree.map(torch.tensor, p),
                                jax.tree.map(torch.tensor, g),
                                donate=bool(trial % 2))
        assert int(ts2.step) == int(js2.step) == step + 1
        assert ts2.step.dtype == torch.int32
        assert np.float32(jm["lr"]) == tm["lr"].item()
        assert abs(float(jm["grad_norm"]) - tm["grad_norm"].item()) <= (
            1e-6 * float(jm["grad_norm"]))
        for part, a, b in (("mu", js2.mu, ts2.mu), ("nu", js2.nu, ts2.nu)):
            for path, x, y in _pairs(a, b):
                assert y.dtype == mdt
                assert np.array_equal(x.astype(np.float32),
                                      y.float().numpy()), (part, path)
        for path, x, y in _pairs(jp, tp):
            u = _ulps(x, y.numpy()).max()
            worst = max(worst, u)
            assert u <= (1 if name == "adamw" else 0), (path, u)
    print(f"{name} {schedule} {moments}: parameters within {worst} ulp")


def test_compression_matches_reference_bitwise():
    rng = np.random.default_rng(3)
    for trial in range(30):
        g = _np_tree(trial, 10.0 ** rng.uniform(-8, 3))
        r = _np_tree(trial + 100, 1e-3)
        jg, js, jm = RC.compress_grads(
            jax.tree.map(jnp.asarray, g),
            RC.CompressionState(jax.tree.map(jnp.asarray, r)))
        tg, ts, tm = C.compress_grads(
            jax.tree.map(torch.from_numpy, g),
            C.CompressionState(jax.tree.map(torch.from_numpy, r)))
        for a, b in ((jg, tg), (js.residual, ts.residual)):
            for path, x, y in _pairs(a, b):
                assert np.array_equal(x, y.numpy()), path
        jq, jscale = RC._quantize_int8(jnp.asarray(g["b"]))
        tq, tscale = C._quantize_int8(torch.from_numpy(g["b"]))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.float32(jscale) == tscale.item()
        err = float(jm["compress_err_l1"])
        assert abs(err - tm["compress_err_l1"].item()) <= 1e-6 * err


@pytest.mark.parametrize("arch", DENSE)
def test_synthetic_batches_bitwise(arch):
    rc, tc = rconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    want = RSyn.token_batches(rc, RShape("s", 24, 3, "train"), seed=7,
                              start_step=2)
    got = synthetic.token_batches(tc, ShapeConfig("s", 24, 3, "train"),
                                  seed=7, start_step=2)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k


def _states(arch, compress):
    """The same TrainState in both packages: reference-initialised
    parameters, moments and residual filled from a numpy seed, step 5."""
    rc, tc = rconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    rtc = RTS.TrainConfig(grad_compress=compress)
    prm = RP.materialize(RT.model_specs(rc), jax.random.PRNGKey(0),
                         jnp.float32)
    rng = np.random.default_rng(4)

    def fill(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))

    st = RTS.init_state(rtc, prm)
    st = RTS.TrainState(
        params=st.params,
        opt=RO.OptState(jnp.int32(5), jax.tree.map(fill, st.opt.mu),
                        jax.tree.map(fill, st.opt.nu)),
        compress=None if st.compress is None else RC.CompressionState(
            jax.tree.map(fill, st.compress.residual)))
    return rc, tc, st


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_train_state_checkpoint_crosses_packages(direction, compress,
                                                 tmp_path):
    """A TrainState checkpoint written by either package restores in the
    other, key for key and bit for bit (NamedTuples in a NamedTuple, a 0-d
    int32 step, a None compression state); the manifests agree."""
    rc, tc, jst = _states("gemma3_1b", compress)
    host = jax.tree.map(np.asarray, jst)
    tst = convert.lm_train_state_from_numpy(host, tc, "cpu")
    if direction == "jax_to_port":
        r_ckpt.save(str(tmp_path), 5, jst)
        got, man = ckpt.restore_tensors(str(tmp_path), tst)
        assert isinstance(got, TrainState) and isinstance(got.opt,
                                                          opt.OptState)
        assert got.opt.step.dtype == torch.int32 and got.opt.step.dim() == 0
        assert (got.compress is None) == (not compress)
        want, got = host, convert.lm_train_state_to_numpy(got)
    else:
        ckpt.save(str(tmp_path), 5, tst)
        got, man = r_ckpt.restore(str(tmp_path), jst)
        want = host
        got = jax.tree.map(np.asarray, got)
    assert man["step"] == 5
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    r_ckpt.save(str(tmp_path / "j"), 5, jst)
    ckpt.save(str(tmp_path / "t"), 5, tst)
    mj, mt = (r_ckpt.read_manifest(str(tmp_path / d)) for d in "jt")
    assert (mj["keys"], mj["dtypes"], mj["shapes"]) == (
        mt["keys"], mt["dtypes"], mt["shapes"])


def test_train_state_from_numpy_checks_keys():
    rc, tc, jst = _states("granite_8b", False)
    host = jax.tree.map(np.asarray, jst)
    bad = host._replace(opt=host.opt._replace(
        mu={k: v for k, v in host.opt.mu.items() if k != "embed"}))
    with pytest.raises(ValueError, match="keys"):
        convert.lm_train_state_from_numpy(bad, tc, "cpu")
