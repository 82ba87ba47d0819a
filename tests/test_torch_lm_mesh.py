"""The LM half of the mesh on 4 gloo ranks on the CPU: ``loss_fn`` and
``train_step`` on a state laid out over a (data, model) mesh by the
reference's rules (FSDP over data, TP / EP over model) as DTensors, held
to the port without a mesh and to the reference's single-device loss,
and a checkpoint written under one mesh restored under another.

Three smoke configs at float32 (and three more, below): granite_8b (the reference's own sharded
test; here with ``remat="dots"``, so the backward recomputes each
super-block under the mesh), gemma3_1b (one kv head: the heads' rule falls back to
replication) and olmoe_1b_7b (experts over model; the dispatch groups
are the data group size, and the unsharded runs use as many). The ranks
run ``tests/torch_lm_mesh_ranks.py`` (one spawn an arch, 120 s at most,
every rank's error reported) and send back rank 0's gathered state. The
spawns start in two waves (the dense and MoE archs with ``misc``, then
the block archs), and each holds 4 of the host's rank slots
(``torch_lm_mesh_ranks.rank_slots``, shared with
``test_torch_lm_mesh_serve.py``) while it runs.

Tolerances:
* the loss on meshes (2, 2), (4, 1) and (1, 4) (each case's first
  step): within 1e-5 relative of the unsharded port's and of the
  reference's; the logits reach the vocabulary-parallel cross-entropy
  sharded over ``model``, each rank's block V / model wide;
* 3 AdamW steps, plain on (2, 2), two microbatches on (4, 1), int8
  compression on (1, 4): parameters, moments and residual within 1e-4 of
  each leaf's range of the unsharded port's after every step, with
  ``test_torch_lm_train``'s exemptions (the noise-level gradients AdamW
  moves by about lr, held to the gap the two runs' moments imply; the
  int8 levels a last-bit difference rounds the other way at a
  half-level, listed and left out);
* every leaf's local shard is the block its spec implies (checked on
  the ranks after every step);
* mamba2_780m on (2, 2), recurrentgemma_9b on (1, 4) and
  llama32_vision_11b on (2, 2) (the SSD, RG-LRU and CROSS blocks): 3
  AdamW steps each, held as above;
* reshard-on-load: the (2, 2) state after step 3, saved, restores on
  (4, 1), on (1, 4) and without a mesh bitwise, and a 4th step from each
  is held to the uninterrupted unsharded run as above.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as ranks_mod
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.distributed import sharding as shd
from repro_torch.launch import ranks
from repro_torch.models import transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS
from test_torch_lm_train import (
    LOSS_TOL, TOL, _add_flips, _adamw_gaps, _cfgs, _close_trees, _flat,
    np_batch, np_params,
)

ARCHS = ["granite_8b", "gemma3_1b", "olmoe_1b_7b"]
PLAN = {"train": [("adamw", (2, 2)), ("microbatches", (4, 1)),
                  ("grad_compress", (1, 4))],
        "reshard": [(4, 1), (1, 4)]}
# the SSD, RG-LRU and CROSS blocks: 3 AdamW steps each, mamba2 on (2, 2)
# (its chunks over model, the batch over data), recurrentgemma on (1, 4)
# (the recurrence's channels over model), the vlm on (2, 2)
BLOCK_MESH = {"mamba2_780m": (2, 2), "recurrentgemma_9b": (1, 4),
              "llama32_vision_11b": (2, 2)}
BLOCK_ARCHS = list(BLOCK_MESH)
CASE_MESH = dict(PLAN["train"])
BATCH = 4


def _groups(arch, shape) -> int:
    return shape[0] if configs.get_smoke_config(arch).moe is not None else 1


def _inputs(arch):
    rc, _ = _cfgs(arch)
    prm = np_params(rc, seed=21)
    batches = [np_batch(rc, seed=30 + i, b=BATCH) for i in range(4)]
    return rc, prm, batches


# olmoe's ranks run their collectives through the staged backend (the
# one ranks sharing a card use), the others through gloo
STAGED = {"olmoe_1b_7b"}


def _spawn(arch, ckpt_dir):
    try:
        with ranks_mod.rank_slots(4):
            if arch == "misc":
                return ranks.spawn(ranks_mod.misc, 4, (ckpt_dir,),
                                   device="cpu", timeout_s=120, staged=True)
            _, prm, batches = _inputs(arch)
            plan = ({"train": [("adamw", BLOCK_MESH[arch])], "reshard": []}
                    if arch in BLOCK_MESH else PLAN)
            # the block archs' steps are the longest: a longer limit (it
            # only guards against a hang)
            return ranks.spawn(ranks_mod.run, 4, (arch, prm, batches, plan,
                                                  ckpt_dir),
                               device="cpu",
                               timeout_s=300 if arch in BLOCK_ARCHS else 120,
                               staged=arch in STAGED)[0]
    except RuntimeError as e:
        return e


# the spawns in waves: the dense and MoE archs and ``misc`` first, then
# the block archs, so that no wave puts more ranks on the cores than the
# first did
WAVES = (ARCHS + ["misc"], BLOCK_ARCHS)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every arch's 4 ranks, and the ``misc`` ranks, in :data:`WAVES` (a
    wave's spawns at once, each its own limit, each holding its rank
    slots): {arch: (checkpoint dir, rank 0's results or the error)}."""
    root = tmp_path_factory.mktemp("lm_mesh")
    out = {}
    for wave in WAVES:
        with ThreadPoolExecutor(len(wave)) as pool:
            futures = {a: pool.submit(_spawn, a, str(root / a))
                       for a in wave}
            out.update({a: (root / a, f.result())
                        for a, f in futures.items()})
    return out


def _run(arch, sharded):
    """Rank 0's results, or the spawn's error (every rank's traceback, or
    the ranks that gave no result in time) raised in the test."""
    got = sharded[arch][1]
    if isinstance(got, Exception):
        raise RuntimeError(f"{arch}'s ranks failed: {got}") from got
    return got


@functools.lru_cache(maxsize=None)
def _ref_loss_fn(arch, groups):
    rc, _ = _cfgs(arch)
    return jax.jit(lambda p, b: RT.loss_fn(rc, p, b, num_groups=groups)[0])


def _unsharded(arch, case, shape, n_steps=3, batches=None):
    """The port without a mesh: the states and metrics of each step."""
    _, prm, b = _inputs(arch)
    batches = batches or b
    cfg = ranks_mod.config(arch)
    tc = ranks_mod.train_config(cfg, case, _groups(arch, shape))
    state = TS.init_state(tc, T.map(torch.tensor, prm))
    out = []
    for k in range(n_steps):
        state, m = TS.train_step(cfg, tc, state, batches[k])
        out.append((ranks_mod.host(state), {key: float(v)
                                            for key, v in m.items()}))
    return out, state, tc


def _hold(arch, case, got_steps, want_steps, lr_of, oc):
    flips: dict = {}
    amplified: dict = {}
    _, prm, _ = _inputs(arch)
    prev = (prm, prm)
    for i, ((got, gm), (want, wm)) in enumerate(zip(got_steps, want_steps)):
        assert abs(gm["loss"] - wm["loss"]) <= LOSS_TOL * abs(wm["loss"])
        if got.compress is not None:
            _add_flips(flips, got.compress.residual, want.compress.residual)
        parts = {"params": lambda s: s.params, "mu": lambda s: s.opt.mu,
                 "nu": lambda s: s.opt.nu}
        if got.compress is not None:
            parts["residual"] = lambda s: s.compress.residual
        for part, get in parts.items():
            g = get(got)
            if part == "params":
                adj = _adamw_gaps(got, want, prev, lr_of(wm), i + 1, oc,
                                  amplified)
                g = T.unflatten(get(want), [adj[p] for p, _ in
                                            _flat(get(want))])
            _close_trees(g, get(want), TOL, f"{arch} {case} step {i + 1} "
                         f"{part}", allow=flips,
                         range_of=254.0 if part == "residual" else 1.0)
        assert int(got.opt.step) == int(want.opt.step) == i + 1
        prev = (got.params, want.params)
    n = sum(map(len, amplified.values()))
    if n or any(flips.values()):
        print(f"{arch} {case}: {n} AdamW-amplified elements; int8 levels "
              f"apart: {sum(map(len, flips.values()))}")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_unsharded_and_reference(arch, sharded):
    """The first step's loss (at the initial parameters, on the first
    batch) on each mesh: (2, 2), (4, 1) (two microbatches: the mean of
    the halves' losses, each with its own MoE dispatch groups) and
    (1, 4)."""
    rc, prm, batches = _inputs(arch)
    run = _run(arch, sharded)["train"]
    cfg = ranks_mod.config(arch)
    for case, shape in PLAN["train"]:
        got = run[case][0][1]["loss"]
        g = _groups(arch, shape)
        m = ranks_mod.train_config(cfg, case, g).microbatches
        halves = [{k: np.split(v, m)[i]
                   for k, v in batches[0].items()} for i in range(m)]
        want = ref = 0.0
        for half in halves:
            with torch.no_grad():
                w, _ = transformer.loss_fn(cfg, T.map(torch.tensor, prm),
                                           TS.batch_on(half, "cpu"),
                                           num_groups=g)
            r = _ref_loss_fn(arch, g)(jax.tree.map(jnp.asarray, prm),
                                      jax.tree.map(jnp.asarray, half))
            want, ref = want + float(w) / m, ref + float(r) / m
        for other, name in ((want, "port"), (ref, "ref")):
            err = abs(got - other) / abs(other)
            assert err <= LOSS_TOL, f"{arch} {shape} vs {name}: {err:.2e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_takes_the_logits_vocab_sharded(arch, sharded):
    """The logits reach the cross-entropy as the head's product leaves
    them, the vocabulary over ``model`` (nothing gathers it whole): each
    rank's block is V / model wide on (2, 2) and (1, 4), and whole on
    (4, 1)."""
    got = _run(arch, sharded)["loss_logits"]
    V = configs.get_smoke_config(arch).vocab_size
    for _, shape in PLAN["train"]:
        placements, local = got[shape]
        model = shape[1]
        assert local[-1] == V // model, (shape, local, V)
        if model > 1:
            assert placements.endswith("Shard(dim=2))"), (shape, placements)
        else:
            assert "Shard(dim=2)" not in placements, (shape, placements)


@pytest.mark.parametrize("arch,case", [(a, c) for a in ARCHS
                                       for c in CASE_MESH])
def test_sharded_train_steps_match_unsharded(arch, case, sharded):
    got = _run(arch, sharded)["train"][case]
    want, _, tc = _unsharded(arch, case, CASE_MESH[case])
    _hold(arch, case, got, want, lambda m: m["lr"], tc.opt)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_are_the_rules_size(arch, sharded):
    """Each rank holds the parameters' elements the rules imply (the
    ranks checked every leaf's block; here the totals): never the whole
    tree, and exactly the sum of the blocks."""
    got = _run(arch, sharded)["local"]
    cfg = ranks_mod.config(arch)
    specs = transformer.model_specs(cfg)
    whole = sum(int(np.prod(s.shape)) for s in _spec_leaves(specs))
    for shape, n in got.items():
        mesh = ranks_mod_mesh(shape)
        want = 0
        for s, sh in zip(_spec_leaves(specs), T.leaves(
                shd.param_shardings(specs, mesh, shd.ShardingPolicy()))):
            size = int(np.prod(s.shape))
            for entry in sh.spec:
                for a in (entry if isinstance(entry, tuple) else
                          (() if entry is None else (entry,))):
                    size //= mesh.shape[a]
            want += size
        assert n == want, (shape, n, want)
        assert n < whole


def ranks_mod_mesh(shape):
    from repro_torch.launch.mesh import abstract_mesh

    return abstract_mesh(shape, ranks_mod.NAMES)


def _spec_leaves(specs):
    out = []
    for k in sorted(specs):
        v = specs[k]
        out.extend(_spec_leaves(v) if isinstance(v, dict) else [v])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_reshard_on_load(arch, sharded):
    """Saved on (2, 2) after 3 steps; restored on (4, 1) and (1, 4) (the
    ranks checked each bitwise against the saved state) and without a
    mesh (here), then one more step from each, held to the
    uninterrupted unsharded run's 4th step."""
    run = _run(arch, sharded)
    case, shape = PLAN["train"][0]
    _, prm, batches = _inputs(arch)
    want_steps, _, tc = _unsharded(arch, case, shape, n_steps=4)
    saved = run["train"][case][-1][0]
    template = TS.init_state(tc, T.map(torch.tensor, prm))
    restored, _ = ckpt.restore_tensors(str(sharded[arch][0]), template)
    for a, b in zip(T.leaves(ranks_mod.host(restored)), T.leaves(saved)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = ranks_mod.config(arch)
    cont, _ = TS.train_step(cfg, tc, restored, batches[3])
    outs = dict(run["reshard"])
    outs[None] = ranks_mod.host(cont)
    want = want_steps[3][0]
    prev = (saved, want_steps[2][0])
    for where, got in outs.items():
        amplified: dict = {}
        adj = _adamw_gaps(got, want, (prev[0].params, prev[1].params),
                          want_steps[3][1]["lr"], 4, tc.opt, amplified)
        g = T.unflatten(want.params, [adj[p] for p, _ in _flat(want.params)])
        _close_trees(g, want.params, TOL, f"{arch} step 4 after restore on "
                     f"{where} params")
        _close_trees(got.opt.mu, want.opt.mu, TOL, f"{where} mu")
        _close_trees(got.opt.nu, want.opt.nu, TOL, f"{where} nu")


def test_staged_backend_carried_the_collectives(sharded):
    """olmoe's ranks ran on the staged backend: its all-gathers,
    reduce-scatters and all-reduces were counted (the train-step tests
    above hold what they computed)."""
    run = _run("olmoe_1b_7b", sharded)
    for op in ("all_gather", "reduce_scatter", "all_reduce"):
        calls, nbytes = run["staged"][op]
        assert calls > 0 and nbytes > 0, (op, run["staged"])


def test_staged_shard_to_shard_and_agreement(sharded):
    """On 4 staged ranks: the kernel the staged backend registers for
    DTensor's Shard -> Shard move gives the whole tensor's chunk, as
    DTensor's own move on the CPU does; ``agree``
    gives every rank the largest loss and time, and NaN when any rank's
    loss is NaN."""
    outs = _run("misc", sharded)
    for r, out in enumerate(outs):
        assert out["alltoall"], r
        assert out["agree"] == (3.0, 1.5), (r, out["agree"])
        assert out["agree_nan"], r


def test_sharded_loop_agrees_and_resumes_on_another_mesh(sharded):
    """``loop.run`` over a (2, 2)-sharded olmoe state, 4 steps, a
    checkpoint every 2; at step 1 one rank's loss is NaN: every rank
    records the same fault, skips the same update and keeps the same
    losses; the last checkpoint (step 4, written collectively) resumes
    on (4, 1) at step 3's update count."""
    outs = _run("misc", sharded)
    reports = [o["report"] for o in outs]
    assert all(r == reports[0] for r in reports), reports
    steps_run, faults, losses, step = reports[0]
    assert faults == [(1, "nan_loss")]
    assert steps_run == 3 and len(losses) == 3 and step == 3
    assert all(o["resumed_step"] == 3 for o in outs)


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_sharded_block_train_steps_match_unsharded(arch, sharded):
    """mamba2 (SSD: the chunk views and the inter-chunk states hinted
    over model, the conv on each rank's rows and channels),
    recurrentgemma (RG-LRU: the conv, gates and scan on each rank's rows
    and channels) and llama-3.2-vision (CROSS: the cross-attention on
    each rank's rows and heads): the loss within 1e-5 relative and the
    state within 1e-4 of each leaf's range of the unsharded port after
    each of 3 AdamW steps, as the dense and MoE cases above."""
    got = _run(arch, sharded)["train"]["adamw"]
    want, _, tc = _unsharded(arch, "adamw", BLOCK_MESH[arch])
    _hold(arch, "adamw", got, want, lambda m: m["lr"], tc.opt)
