"""The rank side of ``tests/test_torch_lm_mesh_serve.py``: what each of 4
gloo ranks runs (``repro_torch.launch.ranks.spawn`` imports this module
in every child; it imports no JAX). Each case builds the serving cells of
``repro_torch.launch.dryrun.build_cell`` on its mesh, prefills a prompt
and decodes given tokens, and rank 0 sends back the logits of every
step, the gathered cache and the MoE routing it saw."""
import contextlib
import dataclasses

import torch

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import moe

NAMES = ("data", "model")


def host(tree):
    """The whole of a (sharded) tree as numpy copies (collective)."""
    return T.map(lambda x: x.detach().cpu().numpy().copy()
                 if torch.is_tensor(x) else x, shd.gather(tree))


def config(arch, cfg_kw):
    return dataclasses.replace(configs.get_smoke_config(arch), **cfg_kw)


def serve(rank, world, arch, cfg_kw, prm, prompt, new_tokens, plan,
          extra=None, device="cpu"):
    """``plan``: {case: (mesh shape, max_seq, decode global batch)} (a
    3-dim shape is (pod, data, model)): on
    each mesh, ``build_cell``'s prefill (the prompt into a ``max_seq``
    cache laid out by ``cache_shardings``) and then its decode cell for
    each of ``new_tokens``' columns. ``extra``: the prompt batch's other
    leaves (a vlm's ``cross_embeds``). Returns (rank 0) {case: {"logits":
    [prefill, step 1, ...], "cache": the cache after the last step,
    "routing": (expert_idx, pos, keep) of the first MoE layer on the
    prompt, or None}}."""
    cfg = config(arch, cfg_kw)
    B, S = prompt.shape
    out = {}
    for case, (shape, max_seq, dec_batch) in plan.items():
        names = NAMES if len(shape) == 2 else ("pod",) + NAMES
        mesh = RankMesh(shape, names, device=device)
        pre = ShapeConfig(case, max_seq, B, "prefill")
        dec = ShapeConfig(case, max_seq, dec_batch, "decode")
        params = dict(prm)
        batch = {"tokens": prompt, **(extra or {})}
        got = {"logits": []}
        seen = []
        with dryrun.serving(cfg, pre, mesh), _spy(seen):
            fn, args = dryrun.build_cell(cfg, pre, mesh, params=params,
                                         batch=batch)
            logits, cache = fn(*args)
            got["logits"].append(host(logits))
        got["routing"] = (tuple(host(t) for t in seen[0]) if seen
                          else None)
        with dryrun.serving(cfg, dec, mesh):
            for i in range(new_tokens.shape[1]):
                b = {"token": new_tokens[:, i:i + 1], "pos": S + i}
                fn, args = dryrun.build_cell(cfg, dec, mesh, params=args[0],
                                             batch=b, cache=cache)
                logits, cache = fn(*args)
                got["logits"].append(host(logits))
        got["cache"] = host(cache)
        got["placements"] = {
            "/".join(k): str(tuple(v.placements)) for k, v in
            _flat(cache)}
        out[case] = got
    return out if rank == 0 else None


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


@contextlib.contextmanager
def _spy(seen: list):
    """Keep the routing integers (expert, slot, kept) of every
    ``moe.route`` call made inside."""
    orig = moe.route

    def route(cfg, p, xt):
        r = orig(cfg, p, xt)
        seen.append((r.expert_idx, r.pos, r.keep))
        return r

    moe.route = route
    try:
        yield
    finally:
        moe.route = orig
