"""The port's LM sharding rules against the reference's, entry for entry.

``spec_partition`` / ``param_shardings`` for every LM arch's full
``model_specs`` on the meshes (4, 2), (2, 16), (16, 16) and ("pod",
"data", "model") (2, 16, 16), under the training policy and the two
serving policies of the reference's dry run (``launch/dryrun.py:46-56``:
experts over data, no FSDP, the sequence over model for small-batch
decode); ``batch_shardings`` on ``stubs.input_specs`` of every cell;
``cache_shardings`` on ``cache_struct`` at S = 4096 and 32768. The
reference's side runs on jax's ``AbstractMesh(axis_sizes, axis_names)``,
the port's on a ``Mesh`` over ``"meta"`` devices. Then twins of the
reference's rule and ``autoshard`` tests (``tests/test_distribution.py``),
and the mapping of specs to DTensor placements.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as PS

from repro import configs as rconfigs
from repro.configs.base import SHAPES as RSHAPES
from repro.distributed import sharding as RS
from repro.models import stubs as RSTUBS
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import autoshard
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import stubs, transformer
from repro_torch.models.params import PSpec

MESHES = [((4, 2), ("data", "model")), ((2, 16), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["4x2", "2x16", "16x16", "2x16x16"]


# a cell of each policy: train, serving (prefill / large-batch decode),
# serving small-batch decode
_POLICY_CELLS = {"train": SHAPES["train_4k"], "serve": SHAPES["prefill_32k"],
                 "serve_sp": SHAPES["long_500k"]}


def _policies(mod):
    """The three policies of the reference dry run's ``_policy_for``
    (``launch/dryrun.py:46-56``): the port's from ``sharding.policy_for``;
    the reference's built as that function builds them (importing its
    dry run sets ``XLA_FLAGS`` for the whole process;
    ``tests/test_torch_dryrun.py`` holds the two functions against each
    other in a subprocess)."""
    if mod is shd:
        return {k: shd.policy_for(None, s) for k, s in _POLICY_CELLS.items()}
    serve = dict(mod.DEFAULT_RULES)
    serve["experts"] = "data"
    return {"train": mod.ShardingPolicy(),
            "serve": mod.ShardingPolicy(rules=serve, fsdp=False),
            "serve_sp": mod.ShardingPolicy(rules=dict(serve), fsdp=False,
                                           seq_axis="model")}


def _entries(spec, ndim):
    """A spec's entries padded with None to ``ndim`` (the reference's
    PartitionSpec may be shorter than the rank)."""
    parts = tuple(spec)
    return parts + (None,) * (ndim - len(parts))


def _ref_leaves(tree):
    return [s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))]


def _same(ref_tree, port_tree, shapes):
    ref = _ref_leaves(ref_tree)
    port = T.leaves(port_tree)
    assert len(ref) == len(port) == len(shapes)
    for r, p, shape in zip(ref, port, shapes):
        assert _entries(r.spec, len(shape)) == _entries(p.spec, len(shape)), \
            (shape, r.spec, p.spec)


def _spec_shapes(specs):
    out = []
    for k in sorted(specs):
        v = specs[k]
        out.extend(_spec_shapes(v) if isinstance(v, dict) else [v.shape])
    return out


@pytest.mark.parametrize("mesh_shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_shardings_match_reference(arch, mesh_shape, names):
    rmesh = AbstractMesh(mesh_shape, names)
    pmesh = abstract_mesh(mesh_shape, names)
    rspecs = RT.model_specs(rconfigs.get_config(arch))
    pspecs = transformer.model_specs(configs.get_config(arch))
    shapes = _spec_shapes(pspecs)
    rpol, ppol = _policies(RS), _policies(shd)
    for name in rpol:
        _same(RS.param_shardings(rspecs, rmesh, rpol[name]),
              shd.param_shardings(pspecs, pmesh, ppol[name]), shapes)


def _struct_shapes(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_struct_shapes(v) if isinstance(v, dict)
                   else [tuple(v.shape)])
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_shardings_match_reference(arch):
    """Every cell's inputs (train, prefill, decode with its cache) on
    every mesh under every policy."""
    rcfg, pcfg = rconfigs.get_config(arch), configs.get_config(arch)
    rpol, ppol = _policies(RS), _policies(shd)
    for sname, shape in SHAPES.items():
        if shape.kind == "decode" and shape.seq_len > 32768:
            shape = dataclasses.replace(shape, seq_len=32768)
        rshape = dataclasses.replace(RSHAPES[sname], seq_len=shape.seq_len)
        rb = RSTUBS.input_specs(rcfg, rshape)
        pb = stubs.input_specs(pcfg, shape)
        shapes = _struct_shapes(pb)
        for (mesh_shape, names) in MESHES:
            rmesh = AbstractMesh(mesh_shape, names)
            pmesh = abstract_mesh(mesh_shape, names)
            for name in rpol:
                _same(RS.batch_shardings(rb, rmesh, rpol[name]),
                      shd.batch_shardings(pb, pmesh, ppol[name]), shapes)


@pytest.mark.parametrize("seq", [4096, 32768])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_shardings_match_reference(arch, seq):
    """The key-aware cache rule (k / v by length, ck / cv batch only, the
    recurrent states' inner width over model) at batch 16 and 1."""
    rcfg, pcfg = rconfigs.get_config(arch), configs.get_config(arch)
    rpol, ppol = _policies(RS), _policies(shd)
    for batch in (16, 1):
        rc = RT.cache_struct(rcfg, batch, seq)
        pc = transformer.cache_struct(pcfg, batch, seq)
        shapes = _struct_shapes(pc)
        for (mesh_shape, names) in MESHES:
            rmesh = AbstractMesh(mesh_shape, names)
            pmesh = abstract_mesh(mesh_shape, names)
            for name in rpol:
                _same(RS.cache_shardings(rc, rmesh, rpol[name]),
                      shd.cache_shardings(pc, pmesh, ppol[name]), shapes)


# -- twins of the reference's tests/test_distribution.py -------------------


def _mesh(shape, names):
    return abstract_mesh(shape, names)


def test_spec_partition_rules():
    mesh = _mesh((1, 1), ("data", "model"))
    pol = shd.ShardingPolicy(fsdp=False)
    ps = shd.spec_partition(PSpec((100, 64), ("vocab", "embed")), mesh, pol)
    assert ps == shd.PartitionSpec("model", None)
    mesh16 = _mesh((1,), ("model",))
    ps = shd.spec_partition(PSpec((7, 3), ("kv_heads", "head_dim")), mesh16,
                            pol)
    assert ps in (shd.PartitionSpec("model", None),
                  shd.PartitionSpec(None, None))


def test_fsdp_shards_largest_free_dim():
    mesh = _mesh((2, 16), ("data", "model"))
    ps = shd.spec_partition(PSpec((128, 64), ("embed", "ff")), mesh,
                            shd.ShardingPolicy())
    assert ps == shd.PartitionSpec("data", "model")
    # the reference on jax 0.9's AbstractMesh signature gives the same
    rps = RS.spec_partition(
        RT.PSpec((128, 64), ("embed", "ff")),
        AbstractMesh((2, 16), ("data", "model")), RS.ShardingPolicy())
    assert rps == PS("data", "model")


def test_spec_partition_nondivisible_replicates():
    mesh = _mesh((16,), ("model",))
    ps = shd.spec_partition(PSpec((7, 3), ("kv_heads", "head_dim")), mesh,
                            shd.ShardingPolicy(fsdp=False))
    assert ps == shd.PartitionSpec(None, None)
    rps = RS.spec_partition(
        RT.PSpec((7, 3), ("kv_heads", "head_dim")),
        AbstractMesh((16,), ("model",)), RS.ShardingPolicy(fsdp=False))
    assert rps == PS(None, None)


def test_fsdp_over_pod_and_data_is_one_tuple_entry():
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    ps = shd.spec_partition(PSpec((1024, 4096), ("embed", "ff")), mesh,
                            shd.ShardingPolicy())
    assert ps == shd.PartitionSpec(("pod", "data"), "model")


def test_autoshard_hint_noop_without_mesh():
    import torch

    x = torch.ones(4, 4)
    assert autoshard.hint(x, "data", None) is x
    # a plain tensor under a mesh passes too
    with autoshard.use(_mesh((2, 2), ("data", "model"))):
        assert autoshard.hint(x, "data", None) is x
        assert autoshard.pin(x) is x
        assert autoshard.whole_dims(x, 0) is x


def test_autoshard_settings():
    mesh = _mesh((1,), ("data",))
    assert autoshard.setting("moe_expert_axis", "model") == "model"
    with autoshard.use(mesh, moe_expert_axis="data"):
        assert autoshard.setting("moe_expert_axis", "model") == "data"
        assert autoshard.current_mesh() is mesh
    assert autoshard.current_mesh() is None
    assert autoshard.setting("moe_expert_axis", "model") == "model"


def test_autoshard_hint_spec_filters_like_reference():
    """The reference's ``_filter_entry``: a divisible dim shards, a
    non-divisible one or a name missing from the mesh replicates, an axis
    used by an earlier dim is dropped."""
    mesh = _mesh((4, 2), ("data", "model"))
    assert autoshard.spec(mesh, (8, 4), "data", None) == \
        shd.PartitionSpec("data", None)
    assert autoshard.spec(mesh, (3, 4), "data", None) == \
        shd.PartitionSpec(None, None)
    assert autoshard.spec(mesh, (8, 4, 6), ("pod", "data"), "model",
                          "data") == shd.PartitionSpec("data", "model", None)
    assert autoshard.spec(mesh, (8, 4), ("data", "model"), None) == \
        shd.PartitionSpec(("data", "model"), None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((2, 4, 2), ("pod", "data", "model"))
    sh = shd.NamedSharding(mesh, shd.PartitionSpec(("pod", "data"), None,
                                                   "model"))
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    assert shd.NamedSharding(mesh, shd.PartitionSpec()).placements() == \
        (Replicate(),) * 3
    # a mesh dim of size 1 holds the whole dim: replicated
    one = _mesh((4, 1), ("data", "model"))
    assert shd.NamedSharding(one, shd.PartitionSpec("model", "data")
                             ).placements() == (Shard(1), Replicate())
    with pytest.raises(ValueError):
        shd.NamedSharding(mesh, shd.PartitionSpec(("data", "pod"))
                          ).placements()


def test_moe_groups_is_the_data_group():
    """The reference dry run's ``_moe_groups``: the product of pod and
    data for a MoE model, 1 for a dense one."""
    moe, dense = configs.get_config("olmoe_1b_7b"), configs.get_config(
        "gemma3_1b")
    assert shd.moe_groups(moe, _mesh((2, 16, 16),
                                     ("pod", "data", "model"))) == 32
    assert shd.moe_groups(moe, _mesh((4, 2), ("data", "model"))) == 4
    assert shd.moe_groups(dense, _mesh((4, 2), ("data", "model"))) == 1
    assert shd.moe_groups(moe, None) == 1


def test_abstract_mesh_is_meta():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    assert isinstance(mesh, Mesh)
    assert dict(mesh.shape) == {"data": 16, "model": 16}
    assert {d.type for d in np.asarray(mesh.devices).reshape(-1)} == {"meta"}
