"""The port's durable service state against the JAX package's.

* save -> restore -> continue equals never stopping, bitwise (banks, RNG
  keys, rings, steps, policy, history, router counters, tuner), packed and
  unpacked: tests/test_residency.py's oracle at ``resident=None``;
* a JAX checkpoint restores in the port and continues bitwise against the
  JAX service continuing, and a port checkpoint restores in the JAX
  package and continues bitwise (interchange, both directions);
* the same state writes identical manifest keys, dtypes and shapes;
* save flushes staged ingress; a mismatched service is rejected; a
  residency checkpoint restores as saved and continues bitwise, and
  migrates to other budgets (tests/test_torch_residency.py holds the rest
  of residency's durable state); the ``OnlineFleet`` passthrough.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import TMConfig as JTMConfig
from repro.core import init_runtime as j_init_runtime
from repro.core import init_state as j_init_state
from repro.serve import AdaptPolicy as JPolicy
from repro.serve import OnlineFleet as JFleet
from repro.serve import ServiceConfig as JConfig
from repro.serve import TMService as JService
from repro.serve import TunableConfig as JTunable
from repro_torch.core import TMConfig as TTMConfig
from repro_torch.core import init_runtime as t_init_runtime
from repro_torch.core import init_state as t_init_state
from repro_torch.serve import AdaptPolicy as TPolicy
from repro_torch.serve import OnlineFleet as TFleet
from repro_torch.serve import ServiceConfig as TConfig
from repro_torch.serve import TMService as TService
from repro_torch.serve import TunableConfig as TTunable
from repro_torch.train import checkpoint as t_ckpt

K, CAP, BLOCK, CHUNK, F = 6, 8, 4, 4, 16
_RNG = np.random.default_rng(42)
EVAL_X = _RNG.random((24, F)) > 0.5
EVAL_Y = _RNG.integers(0, 3, 24)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sc(mod, *, packed=False, tunable=None, resident=None, seed=7):
    policy = (JPolicy if mod == "jax" else TPolicy)(analyze_every=8,
                                                    rollback_threshold=0.1)
    kw = dict(replicas=K, buffer_capacity=CAP, chunk=CHUNK,
              ingress_block=BLOCK, packed=packed, s=3.0,
              # residency needs scalar ports; the others take one T each
              T=15 if resident else [10, 15, 15, 20, 25, 15], seed=seed,
              policy=policy,
              tunable=tunable)
    if mod == "jax":
        return JConfig(resident=resident, **kw)
    return TConfig(**kw)


def _jsvc(*, packed=False, tunable=None, resident=None, backend="ref",
          with_eval=True):
    cfg = JTMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16,
                    backend=backend)
    ev = dict(eval_x=EVAL_X, eval_y=EVAL_Y) if with_eval else {}
    return JService(cfg, j_init_state(cfg), _sc(
        "jax", packed=packed, tunable=tunable, resident=resident), **ev)


def _tsvc(*, packed=False, tunable=None, backend="cuda", with_eval=True):
    cfg = TTMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16,
                    backend=backend)
    ev = dict(eval_x=EVAL_X, eval_y=EVAL_Y) if with_eval else {}
    return TService(cfg, t_init_state(cfg, device="cpu"), _sc(
        "port", packed=packed, tunable=tunable), device="cpu", **ev)


def _drive(svc, n, seed, tick_every=4):
    r = np.random.default_rng(seed)
    for i in range(n):
        svc.submit_rows(r.random(F) > 0.5, int(r.integers(0, 3)))
        if i % tick_every == tick_every - 1:
            svc.tick()
    svc.flush()


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _fingerprint(svc) -> dict:
    """Everything save must carry, as numpy in the reference's types."""
    ss = svc.ss
    x = _np(ss.buf.data_x)
    if x.dtype == np.int32:          # the port's packed words
        x = x.view(np.uint32)
    out = {
        "ta": _np(ss.tm.ta_state), "x": x, "y": _np(ss.buf.data_y),
        "head": _np(ss.buf.head), "size": _np(ss.buf.size),
        "step": _np(ss.step), "keys": np.asarray(svc.rng_keys),
        "since": svc.since_analysis, "rollbacks": svc.rollbacks,
        "lost": svc.lost, "best": svc._ps.best, "dropped": svc.dropped,
        "flushes": np.int64(svc.router.flushes),
        "buffered": svc.buffered,
        "hist_steps": np.asarray([h[0] for h in svc.history]),
        "hist_acc": np.asarray([h[1] for h in svc.history]),
        "best_state": (None if svc._ps.best_state is None
                       else _np(svc._ps.best_state.ta_state)),
    }
    if getattr(svc, "_res", None) is not None:
        out["best_state"] = svc._best_host   # residency keeps it host-side
    if svc.tuner is not None:
        out["tuner"] = (svc.tuner.budget, svc.tuner.order,
                        svc.tuner.weights, svc.tuner.score)
    return out


def _assert_same(a, b, msg=""):
    fa, fb = _fingerprint(a), _fingerprint(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if k == "tuner":
            assert va[0] == vb[0], msg
            for x, y in zip(va[1:], vb[1:]):
                assert (x is None) == (y is None), (k, msg)
                assert x is None or np.array_equal(x, y), (k, msg)
            continue
        if va is None or vb is None:
            assert va is None and vb is None, (k, msg)
            continue
        assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype, msg)
        assert np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), \
            (k, msg)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tuned", [False, True])
def test_save_restore_continuation_bitwise(packed, tuned, tmp_path):
    """save -> restore -> continue == never stopping, in the port."""
    tc = TTunable(budget=0.5, weight_bits=3) if tuned else None
    svc = _tsvc(packed=packed, tunable=tc)
    _drive(svc, 20, seed=5)
    if tuned:
        svc.calibrate()
    svc.save(str(tmp_path))
    other = TService.restore(str(tmp_path), eval_x=EVAL_X, eval_y=EVAL_Y,
                             device="cpu")
    assert other.sc.packed == packed and other.sc.resident is None
    _assert_same(svc, other, "restore changed state")
    _drive(svc, 30, seed=11)
    _drive(other, 30, seed=11)
    _assert_same(svc, other, "post-restore trajectories diverged")
    xs = _RNG.random((5, F)) > 0.5
    assert np.array_equal(svc.serve(xs), other.serve(xs))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tuned", [False, True])
def test_jax_checkpoint_restores_in_the_port(packed, tuned, tmp_path):
    """A JAX checkpoint restores in the port; both continue bitwise."""
    tc = dict(budget=0.5, weight_bits=3) if tuned else None
    js = _jsvc(packed=packed, tunable=None if tc is None else JTunable(**tc))
    _drive(js, 20, seed=5)
    if tuned:
        js.calibrate()
    js.save(str(tmp_path))
    ts = TService.restore(str(tmp_path), eval_x=EVAL_X, eval_y=EVAL_Y,
                          device="cpu")
    assert ts.cfg.backend == "ref"
    _assert_same(js, ts, "the port's restore differs from the JAX state")
    _drive(js, 30, seed=11)
    _drive(ts, 30, seed=11)
    _assert_same(js, ts, "the port diverged from the JAX service")
    xs = _RNG.random((5, F)) > 0.5
    assert np.array_equal(js.serve(xs), ts.serve(xs))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tuned", [False, True])
def test_port_checkpoint_restores_in_jax(packed, tuned, tmp_path):
    """A port checkpoint restores in the JAX package; both continue
    bitwise. The port's backend "cuda" crosses as "pallas"."""
    tc = dict(budget=0.5, weight_bits=3) if tuned else None
    ts = _tsvc(packed=packed,
               tunable=None if tc is None else TTunable(**tc))
    _drive(ts, 20, seed=5)
    if tuned:
        ts.calibrate()
    ts.save(str(tmp_path))
    man = t_ckpt.read_manifest(str(tmp_path))
    assert man["extra"]["service"]["cfg"]["backend"] == "pallas"
    js = JService.restore(str(tmp_path), eval_x=EVAL_X, eval_y=EVAL_Y)
    assert js.cfg.backend == "pallas"
    js.cfg = JTMConfig(**{**vars(js.cfg), "backend": "ref"})
    _assert_same(ts, js, "the JAX restore differs from the port's state")
    _drive(ts, 30, seed=11)
    _drive(js, 30, seed=11)
    _assert_same(ts, js, "the JAX service diverged from the port")


@pytest.mark.parametrize("packed", [False, True])
def test_manifests_identical_for_the_same_state(packed, tmp_path):
    """The same state writes the same keys, dtypes and shapes, and the
    same service manifest apart from the backend's name."""
    tc = dict(budget=0.5, weight_bits=3, early_exit=True, group=2)
    js = _jsvc(packed=packed, tunable=JTunable(**tc))
    ts = _tsvc(packed=packed, tunable=TTunable(**tc), backend="ref")
    for svc in (js, ts):
        _drive(svc, 20, seed=5)
        svc.calibrate()
        svc.save(str(tmp_path / type(svc).__module__))
    mj = t_ckpt.read_manifest(str(tmp_path / JService.__module__))
    mt = t_ckpt.read_manifest(str(tmp_path / TService.__module__))
    for k in ("keys", "dtypes", "shapes", "key_impls", "step", "extra"):
        assert mj[k] == mt[k], k
    assert mt["dtypes"]["keys"] == "uint32"
    assert mt["dtypes"]["ss/1/0"] == ("uint32" if packed else "bool")
    assert mt["dtypes"]["policy/since"] == "int64"
    assert mt["dtypes"]["history/acc"] == "float32"
    assert mt["dtypes"]["tunable/order"] == "int32"
    dj = np.load(os.path.join(str(tmp_path / JService.__module__),
                              "step_000000020", "arrays.npz"))
    dt = np.load(os.path.join(str(tmp_path / TService.__module__),
                              "step_000000020", "arrays.npz"))
    for k in mj["keys"]:
        assert np.array_equal(dj[k], dt[k], equal_nan=dj[k].dtype.kind == "f"
                              ), k


def test_save_flushes_staged_ingress(tmp_path):
    """Rows staged but not flushed at save time are in the saved rings."""
    svc = _tsvc(with_eval=False)
    svc.submit_rows(np.ones(F, dtype=bool), 1)
    assert svc.router.staged.sum() > 0 or svc.buffered.sum() > 0
    svc.save(str(tmp_path))
    other = TService.restore(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(other.buffered, [1] * K)


def test_restore_rejects_mismatched_service(tmp_path):
    svc = _tsvc(with_eval=False)
    svc.save(str(tmp_path))
    with pytest.raises(ValueError, match="packed"):
        _tsvc(packed=True, with_eval=False).load(str(tmp_path))
    cfg = TTMConfig(n_features=F + 1, max_classes=3, max_clauses=16,
                    n_states=16)
    wide = TService(cfg, t_init_state(cfg, device="cpu"), _sc("port"),
                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wide.load(str(tmp_path))
    few = TService(cfg, t_init_state(cfg, device="cpu"),
                   TConfig(replicas=2), device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        few.load(str(tmp_path))


def test_residency_checkpoint_raises_or_migrates(tmp_path):
    """A checkpoint of a JAX residency service restores in the port as
    saved (two device slots) and continues bitwise with the JAX service;
    resident=3 and resident=None migrate it across budgets, continuing
    bitwise too."""
    js = _jsvc(resident=2)
    _drive(js, 20, seed=5)
    js.save(str(tmp_path))
    js.load(str(tmp_path))
    ports = [TService.restore(str(tmp_path), resident=r, eval_x=EVAL_X,
                              eval_y=EVAL_Y, device="cpu")
             for r in ("saved", 3, None)]
    assert [t.sc.resident for t in ports] == [2, 3, None]
    assert [t.n_resident for t in ports] == [2, 3, K]
    for ts in ports:
        _assert_same(js, ts, f"restore at {ts.sc.resident} changed state")
    _drive(js, 12, seed=11)
    jaxes = [JService.restore(str(tmp_path), resident=r, eval_x=EVAL_X,
                              eval_y=EVAL_Y) for r in (3, None)]
    for other in jaxes:
        _drive(other, 12, seed=11)
    for ts, jo in zip(ports, [js] + jaxes):
        _drive(ts, 12, seed=11)
        _assert_same(jo, ts, f"the fleet at {ts.sc.resident} diverged")


def test_fleet_save_restore_passthrough(tmp_path):
    """OnlineFleet checkpoints through the service; the restored port
    fleet continues bitwise with the JAX fleet it was saved beside."""
    jc = JTMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16)
    tc = TTMConfig(n_features=F, max_classes=3, max_clauses=16, n_states=16)
    jf = JFleet(jc, j_init_state(jc), j_init_runtime(jc, s=3.0, T=15),
                n_replicas=4, seed=3)
    tf = TFleet(tc, t_init_state(tc, device="cpu"),
                t_init_runtime(tc, s=3.0, T=15, device="cpu"), n_replicas=4,
                seed=3, device="cpu")
    r = np.random.default_rng(0)
    for _ in range(10):
        x, y = r.random(F) > 0.5, int(r.integers(0, 3))
        jf.offer_rows(x, y)
        tf.offer_rows(x, y)
        jf.drain(2)
        tf.drain(2)
    tf.save(str(tmp_path))
    other = TFleet.restore(str(tmp_path), device="cpu")
    for _ in range(10):
        x, y = r.random(F) > 0.5, int(r.integers(0, 3))
        for f in (jf, tf, other):
            f.offer_rows(x, y)
        n = jf.drain(2)
        assert np.array_equal(n, tf.drain(2))
        assert np.array_equal(n, other.drain(2))
    want = [np.asarray(a) for a in jax.tree.leaves(jf.ss)]
    for f in (tf, other):
        got = [_np(a) for a in (f.ss.tm.ta_state, *f.ss.buf, f.ss.step)]
        assert all(np.array_equal(w, g) for w, g in zip(want, got))
        assert np.array_equal(np.asarray(jf.service.rng_keys),
                              f.service.rng_keys)


def test_checkpoint_layout_and_keep(tmp_path):
    """The reference's layout: step_<n>/arrays.npz + manifest.json, LATEST,
    keep-k, dtypes pinned on restore."""
    d = str(tmp_path)
    tree = {"a": np.arange(3, dtype=np.int8),
            "b": (torch.tensor([1, 2], dtype=torch.int32), None),
            "w": np.array([2**32 - 1], dtype=np.uint32)}
    for step in (1, 2, 3, 4):
        t_ckpt.save(d, step, tree, keep=2)
    assert sorted(p for p in os.listdir(d) if p.startswith("step_")) == [
        "step_000000003", "step_000000004"]
    assert t_ckpt.latest_step(d) == 4
    with open(os.path.join(d, "step_000000004", "manifest.json")) as f:
        man = json.load(f)
    assert man["keys"] == ["a", "b/0", "w"] and man["key_impls"] == {}
    out, _ = t_ckpt.restore(d, {"a": 0, "b": (0, None), "w": 0})
    assert out["a"].dtype == np.int8 and out["b"][0].dtype == np.int32
    assert out["b"][1] is None and out["w"][0] == 2**32 - 1
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"), {})
