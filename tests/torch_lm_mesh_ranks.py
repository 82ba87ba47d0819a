"""The rank side of ``tests/test_torch_lm_mesh.py``: what each of 4 gloo
ranks runs (``repro_torch.launch.ranks.spawn`` imports this module in
every child; it imports no JAX). The test process builds the parameters
and batches with numpy and compares what rank 0 sends back with the
unsharded port and the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as TS

NAMES = ("data", "model")
# granite's runs rematerialise (the backward recomputes each super-block
# under the mesh's hints), the others keep their smoke config's "none"
REMAT = {"granite_8b": "dots"}


def config(arch):
    cfg = configs.get_smoke_config(arch)
    return dataclasses.replace(cfg, remat=REMAT.get(arch, cfg.remat))


def train_config(cfg, case: str, groups: int = 1) -> TS.TrainConfig:
    kw = {"microbatches": {"microbatches": 2},
          "grad_compress": {"grad_compress": True}}.get(case, {})
    return TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=100),
                          moe_num_groups=groups, **kw)


def host(tree):
    """The whole of a (sharded) tree as numpy copies (collective)."""
    return T.map(lambda x: x.detach().cpu().numpy().copy()
                 if torch.is_tensor(x) else x, shd.gather(tree))


def _check_local_shapes(tree, shardings) -> None:
    """Every DTensor leaf's local shard is the block its spec implies:
    each sharded dim divided by the product of its axes' sizes."""
    def one(x, sh):
        want = list(x.shape)
        for d, entry in enumerate(sh.spec):
            for a in (entry if isinstance(entry, tuple) else
                      (() if entry is None else (entry,))):
                want[d] //= sh.mesh.shape[a]
        got = tuple(x.to_local().shape)
        assert got == tuple(want), (got, tuple(want), sh.spec)

    T.map(one, tree, shardings)


def run(rank, world, arch, prm, batches, plan, ckpt_dir, device="cpu"):
    """``plan``: {"train": [(case, mesh shape), ...], "reshard": [mesh
    shape, ...]}. Each case takes 3 steps from ``prm`` on its mesh (the
    first step's loss is the sharded loss at ``prm``); the first case
    saves its 3-step state to ``ckpt_dir``; each reshard mesh restores
    it, checks it bitwise against the saved state and takes step 4.
    Returns (rank 0): {"train": {case: [(state, metrics) after each
    step]}, "reshard": {shape: state after step 4}, "local": {shape:
    local elements of the parameters}}."""
    cfg = config(arch)
    out = {"train": {}, "reshard": {}, "local": {}}
    saved = None
    for i, (case, shape) in enumerate(plan["train"]):
        mesh = RankMesh(shape, NAMES, device=device)
        tc = train_config(cfg, case, shd.moe_groups(cfg, mesh))
        sh = TS.state_shardings(cfg, tc, mesh)
        state = shd.distribute(TS.init_state(tc, T.map(torch.tensor, prm)),
                               sh)
        _check_local_shapes(state, sh)
        out["local"][shape] = shd.local_numel(state.params)
        steps = []
        for k in range(3):
            state, m = TS.train_step(cfg, tc, state, batches[k],
                                     donate=bool(k % 2))
            _check_local_shapes(state, sh)
            steps.append((host(state), {key: float(v) for key, v
                                        in m.items()}))
        out["train"][case] = steps
        if i == 0:
            ckpt.save(ckpt_dir, 3, state)
            saved = (tc, steps[-1][0])
    for shape in plan["reshard"]:
        # the writer's train config (its MoE dispatch groups too): the
        # continued trajectory is the uninterrupted one
        tc, want = saved
        mesh = RankMesh(shape, NAMES, device=device)
        sh = TS.state_shardings(cfg, tc, mesh)
        template = TS.init_state(tc, T.map(torch.tensor, prm))
        lc = loop_mod.LoopConfig(checkpoint_dir=ckpt_dir)
        state = loop_mod.resume_or_init(lc, template, shardings=sh)
        _check_local_shapes(state, sh)
        got = host(state)
        for a, b in zip(T.leaves(got), T.leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"restored on {shape} differs from the saved state"
        state, _ = TS.train_step(cfg, tc, state, batches[3])
        out["reshard"][shape] = host(state)
    out["staged"] = collectives.staged_counts()
    return out if rank == 0 else None


def misc(rank, world, ckpt_dir, device="cpu"):
    """The staged backend's Shard -> Shard kernel against DTensor's own
    move, ``collectives.agree``, and ``loop.run`` over a sharded state
    whose loss is NaN on one rank only at step 1 (every rank must skip
    that update and agree on everything else), its checkpoints collective
    and its resume under another mesh. Returns what each rank saw."""
    import math

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    out = {}
    mesh = RankMesh((2, 2), NAMES, device=device)
    g = torch.arange(48.0, device=mesh.device).reshape(4, 12)
    d = distribute_tensor(g, mesh.device_mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    want = d.redistribute(mesh.device_mesh, [Replicate(), Shard(1)])
    got = collectives._shard_dim_alltoall(
        d.to_local(), 0, 1, mesh.device_mesh.get_group(1).group_name)
    whole = g.chunk(2, dim=1)[mesh.coordinate[1]]
    out["alltoall"] = bool(torch.equal(want.to_local(), got)
                           and torch.equal(got, whole))
    out["agree"] = collectives.agree(float(rank), 0.5 * rank, mesh)
    out["agree_nan"] = math.isnan(collectives.agree(
        float("nan") if rank == 2 else 1.0, 0.0, mesh)[0])
    out["staged"] = collectives.staged_counts()

    cfg = configs.get_smoke_config("olmoe_1b_7b")
    tc = train_config(cfg, "adamw")
    sh = TS.state_shardings(cfg, tc, mesh)
    gen = np.random.default_rng(0)
    prm = T.map(lambda s: torch.tensor(0.05 * gen.standard_normal(s.shape),
                                       dtype=torch.float32),
                shd._map_structs(lambda s: s, transformer.model_specs(cfg)))
    state = shd.distribute(TS.init_state(tc, prm), sh)
    calls = []

    def step_fn(st, batch):
        new, m = TS.train_step(cfg, tc, st, batch)
        k = len(calls)
        calls.append(k)
        if k == 1 and rank == 1:
            m = dict(m, loss=torch.tensor(float("nan")))
        return new, m

    def batches():
        i = 0
        while True:
            r = np.random.default_rng(100 + i)
            yield {"tokens": r.integers(0, cfg.vocab_size, (4, 16)
                                        ).astype(np.int32)}
            i += 1

    lc = loop_mod.LoopConfig(total_steps=4, checkpoint_every=2,
                             checkpoint_dir=ckpt_dir, max_faults=3)
    state, rep = loop_mod.run(lc, state, step_fn, batches(), shardings=sh,
                              log=lambda s: None)
    out["report"] = (rep.steps_run, [f[:2] for f in rep.fault_events],
                     rep.losses, int(state.opt.step))
    mesh41 = RankMesh((4, 1), NAMES, device=device)
    sh41 = TS.state_shardings(cfg, tc, mesh41)
    back = loop_mod.resume_or_init(lc, TS.init_state(tc, prm), shardings=sh41)
    _check_local_shapes(back, sh41)
    out["resumed_step"] = int(shd.gather(back.opt.step))
    return out
