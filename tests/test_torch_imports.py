"""The port stands alone and runs on the card unless told otherwise.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro`` (an AST scan, so imports
  inside functions count too).
* The entry points default to CUDA and raise without it; ``device="cpu"``
  is the explicit way onto the CPU.
* The kernel build raises without ``nvcc``; nothing falls back.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def g():\n    from repro.core import tm\n    import jax\n")
    assert {"repro", "jax"} <= _imported_roots(f)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_runtime, init_state
    from repro_torch.core.accuracy import make_history
    from repro_torch.serve import TMService

    cfg = CONFIG.tm
    for call in (lambda: init_state(cfg), lambda: init_runtime(cfg),
                 lambda: make_history(4, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    state = init_state(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TMService(cfg, state)
    svc = TMService(cfg, state, device="cpu")
    assert svc.serve(np.zeros((2, 16), dtype=bool)).shape == (1, 2)


def test_engine_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import faults
    from repro_torch.eval.crossval import CrossValRun, replicate_state

    cfg = CONFIG.tm
    for call in (lambda: replicate_state(cfg, 2),
                 lambda: faults.fault_free_masks(cfg),
                 lambda: CrossValRun(cfg).sweep(
                     np.zeros((1, 5, 16), bool), np.zeros((1, 5), np.int32),
                     np.zeros((1, 5, 16), bool), np.zeros((1, 5), np.int32),
                     (1.0,), (5,), n_epochs=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_convert_defaults_to_cuda(no_cuda):
    from repro_torch import convert

    with pytest.raises(RuntimeError, match="CUDA"):
        convert.key_from_numpy(np.zeros(2, np.uint32))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
    monkeypatch.setattr(_build, "BUILD", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_scan_covers_the_fleet_and_packed_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"kernels/packing.py", "serve/fleet.py", "serve/online_adapt.py",
            "data/buffer.py", "serve/router.py", "convert.py"} <= names


def test_scan_covers_the_tunable_slice_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"serve/tunable.py", "serve/traffic.py", "train/checkpoint.py",
            "kernels/ref.py", "kernels/clause_eval.py"} <= names


def test_tunable_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The tunable service and restore run on the card unless told
    otherwise; on the CPU the budgeted path serves through K7's plain
    version."""
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_state
    from repro_torch.serve import ServiceConfig, TMService, TunableConfig

    cfg = CONFIG.tm
    sc = ServiceConfig(replicas=2, tunable=TunableConfig(budget=0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        TMService(cfg, init_state(cfg, device="cpu"), sc)
    xs = np.zeros((4, 16), dtype=bool)
    svc = TMService(cfg, init_state(cfg, device="cpu"), sc, eval_x=xs,
                    eval_y=np.zeros(4, np.int32), device="cpu")
    svc.calibrate()
    assert svc.serve(xs).shape == (2, 4)
    svc.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TMService.restore(str(tmp_path))
    assert TMService.restore(str(tmp_path), device="cpu").tuner.calibrated


def test_fleet_entry_points_default_to_cuda(no_cuda):
    from repro_torch import convert
    from repro_torch.configs.tm_iris import CONFIG
    from repro_torch.core import init_runtime, init_state
    from repro_torch.serve import (OnlineFleet, ServiceConfig,
                                   TMFleetAdaptManager, TMService)

    cfg = CONFIG.tm
    state = init_state(cfg, device="cpu")
    rt = init_runtime(cfg, device="cpu")
    xs = np.zeros((4, 16), dtype=bool)
    ys = np.zeros(4, dtype=np.int32)
    for call in (
            lambda: TMService(cfg, state, ServiceConfig(replicas=3,
                                                        packed=True)),
            lambda: OnlineFleet(cfg, state, rt, n_replicas=2),
            lambda: TMFleetAdaptManager(cfg, state, rt, xs, ys,
                                        n_replicas=2),
            lambda: convert.words_from_numpy(np.zeros(2, np.uint32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    svc = TMService(cfg, state, ServiceConfig(replicas=3, packed=True),
                    device="cpu")
    assert svc.serve(xs).shape == (3, 4)


def test_scan_covers_the_lm_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"configs/base.py", "configs/gemma3_1b.py", "models/params.py",
            "models/layers.py", "models/transformer.py", "models/stubs.py",
            "serve/engine.py", "launch/serve.py"} <= names


def test_lm_entry_points_default_to_cuda(no_cuda):
    """The LM serving path runs on the card unless told otherwise."""
    from repro_torch import configs, convert
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import params as P
    from repro_torch.models import stubs, transformer
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = configs.get_smoke_config("gemma3-1b")
    specs = transformer.model_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    tree = P.materialize(specs, gen, device="cpu")
    ec = EngineConfig(max_seq=8, batch_slots=1)
    for call in (lambda: P.materialize(specs, gen),
                 lambda: transformer.Transformer(cfg, tree),
                 lambda: Engine(cfg, tree, ec),
                 lambda: transformer.init_cache(cfg, 1, 8),
                 lambda: stubs.synthetic_batch(
                     cfg, ShapeConfig("s", 8, 1, "prefill")),
                 lambda: convert.lm_params_from_numpy(
                     {k: v.numpy() for k, v in tree.items()
                      if not isinstance(v, dict)}, cfg),
                 lambda: convert.lm_cache_from_numpy({}),
                 lambda: serve.main(["--arch", "gemma3-1b"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    out = Engine(cfg, tree, ec, device="cpu").generate(
        np.zeros((1, 4), np.int32), 4)
    assert out.shape == (1, 4)
    assert serve.main(["--arch", "gemma3-1b", "--device", "cpu",
                       "--max-new", "3"]).shape == (4, 3)


def test_scan_covers_the_lm_training_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"tree.py", "data/synthetic.py", "distributed/collectives.py",
            "train/optimizer.py", "train/train_step.py", "train/loop.py",
            "launch/train.py"} <= names


def test_lm_training_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The trainer and the LM online-adapt manager run on the card unless
    told otherwise, and raise without it; ``--device cpu`` trains on the
    CPU."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serve import OnlineAdaptConfig, OnlineAdaptManager
    from repro_torch.train import train_step as TS

    cfg = configs.get_smoke_config("gemma3-1b")
    gen = torch.Generator().manual_seed(0)
    tree = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
    tc = TS.TrainConfig()
    state = TS.init_state(tc, tree)
    oc = OnlineAdaptConfig(checkpoint_dir=str(tmp_path / "oa"))
    for call in (lambda: OnlineAdaptManager(cfg, tc, state, oc),
                 lambda: train.main(["--arch", "gemma3-1b", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path / "t")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    m = OnlineAdaptManager(cfg, tc, state, oc, device="cpu")
    assert m.state.params["embed"].device.type == "cpu"
    _, report = train.main(["--arch", "gemma3-1b", "--steps", "2",
                            "--seq", "16", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "t")])
    assert report.steps_run == 2


def test_scan_covers_the_lm_mesh_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"distributed/autoshard.py", "distributed/sharding.py",
            "distributed/collectives.py", "launch/mesh.py",
            "launch/ranks.py"} <= names


def test_lm_mesh_entry_points_default_to_cuda(no_cuda):
    """A rank mesh and the ranks' start-up compute on the card unless told
    otherwise, and raise without one; the CPU's ranks take gloo, or the
    staged backend when asked."""
    from repro_torch.launch import mesh as mesh_mod

    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod._rank_device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.init_ranks(0, 1, init_method="file:///nonexistent")
    assert mesh_mod._rank_device("cpu", 3) == torch.device("cpu")
    assert mesh_mod.rank_backend("cpu", 4) == "gloo"
    assert mesh_mod.rank_backend("cpu", 4, staged=True) == "cpu:staged"
