"""Sharded serving on 4 gloo ranks on the CPU: ``launch/dryrun.build_cell``'s
prefill and decode cells (the serving policy of ``sharding.policy_for``:
no FSDP, experts over data, TP over model, and the sequence over model
for a decode batch under 16) on a cache laid out by ``cache_shardings``,
held to the port without a mesh, to the reference's ``prefill`` /
``decode_step``, and to the reference's own sharded ``build_cell`` on 8
forced host devices (4, 2).

Six smoke configs at float32: granite_8b (dense, GQA), gemma3_1b (LOCAL
windows and GLOBAL layers, one kv head), olmoe_1b_7b (MoE, drop-free:
capacity_factor = n_experts, so that the mesh's dispatch groups give
the reference's one-group outputs), mamba2_780m (SSD), recurrentgemma_9b
(RG-LRU) and llama32_vision_11b (CROSS). A prompt of 8 tokens, then 4
given tokens decoded, in three cases:

* ``short``: (2, 2), a 32-slot cache (below 4096: a GLOBAL cache's
  head_dim over ``model``, the partial q.k decode), the decode policy
  without sequence parallelism (a global batch of 16);
* ``long``: (1, 4), a 4096-slot cache (its sequence over ``model``, the
  partial-softmax decode), the SP decode policy (batch 4 < 16);
* ``sp``: (2, 2), 4096 slots, the SP decode policy;
* ``pod`` (olmoe alone): (pod, data, model) = (2, 2, 1), a 32-slot
  cache, the dispatch groups over pod x data and the experts over data:
  the groups stay over ``pod`` at the expert boundary.

Tolerances: logits within 1e-4 of max |ref| against the unsharded port
and the reference (and the reference's sharded cells); greedy tokens
equal, or the reference's top-2 gap within that tolerance; the gathered
cache within 1e-4 of each leaf's range of the unsharded port's; the MoE
routing integers equal to the unsharded port's at the same groups.

The reference's sharded cells: its prefill cell takes the prompt as its
whole cache (``seq_len`` = 8); its decode cell (4096 slots, batch 4: the
SP policy) runs on its own unsharded prefill's cache. They run on a mesh
of Auto axes: jax 0.9's ``jax.make_mesh`` (what the reference's
``make_production_mesh`` calls) makes Explicit axes, and the reference's
``with_sharding_constraint`` then raises a ValueError in every cell
(ROADMAP queue 3). Where a cell raises even so, the test records the
exception (``record_property``) and holds the port to the reference's
unsharded functions alone.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_mesh_serve_ranks as ranks_mod
from torch_lm_mesh_ranks import rank_slots
from repro import configs as rconfigs
from repro.models import transformer as RT
from repro_torch import tree as T
from repro_torch.launch import ranks
from repro_torch.models import moe, transformer
from test_torch_lm_train import np_params

ARCHS = ["granite_8b", "gemma3_1b", "olmoe_1b_7b", "mamba2_780m",
         "recurrentgemma_9b", "llama32_vision_11b"]
PLAN = {"short": ((2, 2), 32, 16), "long": ((1, 4), 4096, 4),
        "sp": ((2, 2), 4096, 4)}
# olmoe also serves on a mesh with a pod axis
POD_PLAN = {"pod": ((2, 2, 1), 32, 16)}
B, S, NEW = 4, 8, 4
TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kw(arch) -> dict:
    cfg = rconfigs.get_smoke_config(arch)
    if cfg.moe is None:
        return {}
    return {"moe": dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts))}


def _inputs(arch):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), **_kw(arch))
    prm = np_params(rc, seed=41)
    rng = np.random.default_rng(42)
    prompt = rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    new = rng.integers(0, rc.vocab_size, (B, NEW)).astype(np.int32)
    extra = None
    if rc.family == "vlm":
        extra = {"cross_embeds": (0.5 * rng.standard_normal(
            (B, rc.n_cross_tokens, rc.d_model))).astype(np.float32)}
    return rc, prm, prompt, new, extra


def _plan(arch) -> dict:
    return {**PLAN, **POD_PLAN} if arch == "olmoe_1b_7b" else PLAN


def _spawn(arch):
    _, prm, prompt, new, extra = _inputs(arch)
    try:
        # 4 of the host's rank slots (shared with test_torch_lm_mesh.py)
        with rank_slots(4):
            return ranks.spawn(ranks_mod.serve, 4,
                               (arch, _kw(arch), prm, prompt, new,
                                _plan(arch), extra),
                               device="cpu", timeout_s=300)[0]
    except RuntimeError as e:
        return e


REF_SHARDED = textwrap.dedent("""\
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ShapeConfig
    from repro.distributed import autoshard
    from repro.launch.dryrun import build_cell
    from repro.models import transformer as RT
    cases = pickle.load(open(sys.argv[1], "rb"))
    # jax 0.9's make_mesh makes Explicit axes, on which the reference's
    # with_sharding_constraint raises; its cells run on Auto axes
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch, (rc, prm, prompt, new, extra) in cases.items():
        got = {}
        prm = jax.tree.map(jnp.asarray, prm)
        batch = {"tokens": jnp.asarray(prompt)}
        batch.update({k: jnp.asarray(v) for k, v in (extra or {}).items()})
        B, S = prompt.shape
        try:
            with mesh, autoshard.use(mesh, moe_expert_axis="data"):
                fn, _ = build_cell(rc, ShapeConfig("p", S, B, "prefill"),
                                   mesh)
                got["prefill"] = np.asarray(fn(prm, batch)[0])
        except Exception as e:
            got["prefill"] = f"{type(e).__name__}: {e}"[:500]
        try:
            _, cache = RT.prefill(rc, prm, batch, 4096)
            steps = []
            with mesh, autoshard.use(mesh, moe_expert_axis="data"):
                fn, _ = build_cell(rc, ShapeConfig("d", 4096, B, "decode"),
                                   mesh)
                for i in range(new.shape[1]):
                    lg, cache = fn(prm, {"token": jnp.asarray(new[:, i:i+1]),
                                         "pos": jnp.int32(S + i)}, cache)
                    steps.append(np.asarray(lg))
            got["decode"] = steps
        except Exception as e:
            got["decode"] = f"{type(e).__name__}: {e}"[:500]
        out[arch] = got
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _ref_sharded(tmp):
    """The reference's own sharded serving cells for every arch, in a
    subprocess on 8 forced host devices."""
    import pickle

    src, dst = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump({a: _inputs(a) for a in ARCHS}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SHARDED, src, dst],
                       capture_output=True, text=True, env=env, timeout=600)
    if r.returncode:
        return RuntimeError(r.stderr[-3000:])
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every arch's 4 ranks and the reference's sharded cells, all at
    once (each spawn's 300-s limit only guards against a hang: 24 ranks
    share the cores): {arch: rank 0's results or the error,
    "ref_sharded": ...}."""
    tmp = str(tmp_path_factory.mktemp("lm_mesh_serve"))
    with ThreadPoolExecutor(len(ARCHS) + 1) as pool:
        futures = {a: pool.submit(_spawn, a) for a in ARCHS}
        futures["ref_sharded"] = pool.submit(_ref_sharded, tmp)
        return {a: f.result() for a, f in futures.items()}


def _got(arch, sharded):
    got = sharded[arch]
    if isinstance(got, Exception):
        raise RuntimeError(f"{arch}'s ranks failed: {got}") from got
    return got


@functools.lru_cache(maxsize=None)
def _unsharded(arch, case):
    """The port without a mesh at the case's dispatch groups: (logits of
    every step, the cache after the last, the first MoE routing)."""
    rc, prm, prompt, new, extra = _inputs(arch)
    cfg = ranks_mod.config(arch, _kw(arch))
    shape, max_seq, _ = _plan(arch)[case]
    groups = int(np.prod(shape[:-1])) if cfg.moe is not None else 1
    params = T.map(torch.tensor, prm)
    batch = {"tokens": torch.tensor(prompt)}
    batch.update({k: torch.tensor(v) for k, v in (extra or {}).items()})
    seen = []
    orig = moe.route

    def spy(*a):
        r = orig(*a)
        seen.append((r.expert_idx, r.pos, r.keep))
        return r

    moe.route = spy
    try:
        lg, cache = transformer.prefill(cfg, params, batch, max_seq,
                                        num_groups=groups)
    finally:
        moe.route = orig
    out = [lg.numpy().copy()]
    for i in range(NEW):
        lg, cache = transformer.decode_step(
            cfg, params, {"token": torch.tensor(new[:, i:i + 1]),
                          "pos": S + i}, cache, num_groups=groups)
        out.append(lg.numpy().copy())
    routing = (tuple(t.numpy() for t in seen[0]) if seen else None)
    return out, T.map(lambda x: x.numpy().copy(), cache), routing


@functools.lru_cache(maxsize=None)
def _reference(arch, max_seq):
    rc, prm, prompt, new, extra = _inputs(arch)
    jp = jax.tree.map(jnp.asarray, prm)
    batch = {"tokens": jnp.asarray(prompt)}
    batch.update({k: jnp.asarray(v) for k, v in (extra or {}).items()})
    pre = jax.jit(RT.prefill, static_argnums=(0, 3))
    dec = jax.jit(RT.decode_step, static_argnums=(0,))
    lg, cache = pre(rc, jp, batch, max_seq)
    out = [np.asarray(lg)]
    for i in range(NEW):
        lg, cache = dec(rc, jp, {"token": jnp.asarray(new[:, i:i + 1]),
                                 "pos": jnp.int32(S + i)}, cache)
        out.append(np.asarray(lg))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _tokens_match(got, want, what):
    """Greedy tokens equal, or the reference's top-2 gap within TOL."""
    for i, (g, w) in enumerate(zip(got, want)):
        for b in np.nonzero(g.argmax(-1) != w.argmax(-1))[0]:
            top2 = np.sort(w[b])[-2:]
            assert top2[1] - top2[0] <= TOL * np.abs(w[b]).max(), \
                f"{what} step {i} row {b}: a token differs off a near-tie"


@pytest.mark.parametrize("arch,case", [(a, c) for a in ARCHS for c in PLAN])
def test_sharded_serving_matches_unsharded_port(arch, case, sharded):
    got = _got(arch, sharded)[case]
    want, want_cache, _ = _unsharded(arch, case)
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        assert _rel(g, w) <= TOL, f"{arch} {case} step {i}: {_rel(g, w):.2e}"
    _tokens_match(got["logits"], want, f"{arch} {case}")
    for (path, a), (_, b) in zip(_leaves(got["cache"]),
                                 _leaves(want_cache)):
        assert a.shape == b.shape, path
        assert _rel(a, b) <= TOL, f"{arch} {case} cache {path}"


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch,case", [(a, c) for a in ARCHS for c in PLAN])
def test_sharded_serving_matches_reference(arch, case, sharded):
    got = _got(arch, sharded)[case]
    want = _reference(arch, PLAN[case][1])
    for i, (g, w) in enumerate(zip(got["logits"], want)):
        assert _rel(g, w) <= TOL, f"{arch} {case} step {i}: {_rel(g, w):.2e}"
    _tokens_match(got["logits"], want, f"{arch} {case} vs reference")


def test_cache_layouts_cover_both_kv_hints(sharded):
    """gemma3's GLOBAL cache (blocks.pos5) shards its sequence over
    model at 4096 slots and its head_dim below; its LOCAL windows shard
    head_dim; mamba2's stacked states shard their layer dim over data
    on (2, 2) (the layer read goes through ``autoshard.layer_of``)."""
    pl = _got("gemma3_1b", sharded)
    assert pl["long"]["placements"]["blocks/pos5/k"] == \
        "(Replicate(), Shard(dim=2))"
    assert pl["sp"]["placements"]["blocks/pos5/k"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert pl["short"]["placements"]["blocks/pos5/k"] == \
        "(Shard(dim=1), Shard(dim=4))"
    assert pl["long"]["placements"]["blocks/pos0/k"] == \
        "(Replicate(), Shard(dim=4))"
    assert _got("mamba2_780m", sharded)["short"]["placements"][
        "blocks/pos0/h"].startswith("(Shard(dim=0)")


@pytest.mark.parametrize("case", list(PLAN))
def test_moe_routing_integers_equal(case, sharded):
    got = _got("olmoe_1b_7b", sharded)[case]["routing"]
    _, _, want = _unsharded("olmoe_1b_7b", case)
    assert got is not None and want is not None
    for g, w, name in zip(got, want, ("expert_idx", "pos", "keep")):
        assert np.array_equal(g, w), (case, name)


def test_moe_pod_mesh_matches_unsharded_port_and_reference(sharded):
    """olmoe on (pod, data, model) = (2, 2, 1): the routing integers
    equal to the unsharded port's at the same 4 groups, the logits of
    the prefill and every decode step within 1e-4 of max |ref| of the
    unsharded port's and of the reference's, greedy tokens as above."""
    got = _got("olmoe_1b_7b", sharded)["pod"]
    want, _, routing = _unsharded("olmoe_1b_7b", "pod")
    for g, w, name in zip(got["routing"], routing,
                          ("expert_idx", "pos", "keep")):
        assert np.array_equal(g, w), name
    ref = _reference("olmoe_1b_7b", POD_PLAN["pod"][1])
    for other, what in ((want, "port"), (ref, "reference")):
        for i, (g, w) in enumerate(zip(got["logits"], other)):
            assert _rel(g, w) <= TOL, f"pod step {i} vs {what}"
        _tokens_match(got["logits"], other, f"pod vs {what}")


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_reference_sharded_cells(arch, sharded, record_property):
    """The port's sharded prefill logits against the reference's sharded
    prefill cell, and its SP decode (case ``sp``) against the reference's
    sharded decode cell on (4, 2). A reference cell that raises is
    recorded; the port is then held to the reference's unsharded
    functions (the tests above) alone."""
    ref = sharded["ref_sharded"]
    if isinstance(ref, Exception):
        raise ref
    ref = ref[arch]
    got = _got(arch, sharded)
    raised = {k: v for k, v in ref.items() if isinstance(v, str)}
    record_property("reference_sharded_raises", json.dumps(raised))
    if not isinstance(ref["prefill"], str):
        assert _rel(got["short"]["logits"][0], ref["prefill"]) <= TOL
    if not isinstance(ref["decode"], str):
        for i, w in enumerate(ref["decode"]):
            g = got["sp"]["logits"][i + 1]
            assert _rel(g, w) <= TOL, f"{arch} decode step {i}"
    assert len(raised) < 2, f"every reference serving cell raised: {raised}"
