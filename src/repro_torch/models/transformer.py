"""Pattern-based decoder stacks for every assigned architecture: GLOBAL and
LOCAL attention with a dense or a mixture-of-experts FFN (``models/moe.py``),
gated cross-attention (CROSS, vlm), the RG-LRU recurrent block
(``models/rglru.py``) and the Mamba-2 SSD block (``models/ssm.py``).

A model is `n_layers` of per-kind blocks described by `cfg.layer_pattern`.
As in the reference, one repetition of the pattern (a super-block) is
stacked: every leaf of ``blocks.pos{i}`` carries a leading ``[n_super]``
layer dim, and the remainder layers sit unstacked under ``rem.rem{i}``. The
parameter and cache trees therefore correspond to the reference's key for
key. Where the reference scans over the stacked dim, the port loops over it
in Python, reading layer ``j`` as a view and writing the stacked cache in
place.

Three temporal modes:
  forward     — full sequence (logits at every position; under autograd
                it trains: :func:`loss_fn`, remat per super-block)
  prefill     — forward + cache construction (serving): K/V for the
                attention layers, the modality embeddings' K/V for CROSS
                layers, the recurrent state and conv tail for RG-LRU and
                SSD layers
  decode_step — one token against the cache (a CROSS layer reads its
                cache and leaves it as it is)

Sliding-window layers keep **window-sized rotating caches** (slot = pos %
window). The MoE FFN returns the router's aux loss, which ``forward`` sums
over the layers and ``loss_fn`` adds; decode and prefill drop it. A vlm
batch carries ``cross_embeds`` [B, N, D] (the stub vision frontend's
embeddings) for the forward and the prefill; decode reads them from the
CROSS layers' caches.

The forward and the loss also run on DTensor parameters and batches laid
out over a ``RankMesh`` (``distributed.sharding``; training over
``torch.distributed`` ranks): the residual stream carries the reference's
hint (``_shard_stream``: batch over the data axes, sequence over
``model``), the embedding gather and the attention core run on each
rank's own rows and heads (``autoshard.local_call``), and the loss runs
on each rank's own block of the vocabulary (:func:`vocab_cross_entropy`:
the logits stay sharded over ``model``, as the head's product leaves
them; the logsumexp and the gold logit are all-reduced over the ranks
that split the vocabulary). Without a mesh every hint is the
identity. Serving runs sharded too: :func:`prefill` and
:func:`decode_step` on DTensor parameters under the serving policy
(``sharding.policy_for``) build and update a cache laid out by
``sharding.cache_shardings`` (the GLOBAL K/V enter it through the
reference's ``kv_hint``), each rank writing its own block of the cache
and attending over it (``layers.attend_cache``: partial softmax over a
sequence-sharded cache, partial q.k over a head_dim-sharded one); a
plain cache is the one block of the same code. ``launch/dryrun.build_cell``
builds these cells.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch import tree as T
from repro_torch.configs.base import (
    CROSS, GLOBAL, LOCAL, RGLRU, SSD, ModelConfig,
)
from repro_torch.core.tm import resolve_device
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import (
    DP, gathered, group_size, hint, is_distributed, layer_of, local_call,
    use_for, write_block,
)
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.params import PSpec, ShapeDtype, stack_specs

_NORMS = ("ln1", "ln2", "final_norm")


def _shard_stream(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream sharding: batch over DP axes, sequence over `model`
    (Megatron-style sequence parallelism: the element-wise and norm work
    stays SP; the ops around attention and the FFN redistribute). The
    identity without an active mesh; dims that do not divide
    replicate."""
    if x.dim() == 3:
        return hint(x, DP, "model", None)
    return x


# the sub-trees whose listed leaves the reference reads in float32
_FLOAT_LEAVES = {"mamba": ssm.FLOAT_LEAVES, "rec": rglru.FLOAT_LEAVES}


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind in (GLOBAL, LOCAL):
        ffn = (moe.moe_specs(cfg) if cfg.moe is not None
               else layers.mlp_specs(cfg))
        return {
            "ln1": layers.norm_specs(cfg),
            "attn": layers.attention_specs(cfg),
            "ln2": layers.norm_specs(cfg),
            "ffn": ffn,
        }
    if kind == CROSS:
        # Gated cross-attention layer (llama-3.2-vision style insertion).
        return {
            "ln1": layers.norm_specs(cfg),
            "xattn": layers.attention_specs(cfg, gated=True),
            "ln2": layers.norm_specs(cfg),
            "ffn": layers.mlp_specs(cfg),
            "ffn_gate": PSpec((), (), "zeros"),
        }
    if kind == RGLRU:
        return {
            "ln1": layers.norm_specs(cfg),
            "rec": rglru.rglru_specs(cfg),
            "ln2": layers.norm_specs(cfg),
            "ffn": layers.mlp_specs(cfg),
        }
    if kind == SSD:
        return {"ln1": layers.norm_specs(cfg), "mamba": ssm.ssd_specs(cfg)}
    raise ValueError(kind)


def _pattern_split(cfg: ModelConfig) -> tuple[int, int]:
    P = len(cfg.layer_pattern)
    return cfg.n_layers // P, cfg.n_layers % P


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    n_super, n_rem = _pattern_split(cfg)
    sp: dict = {}
    if not cfg.embeds_input:
        sp["embed"] = PSpec((v, d), ("vocab", "embed"), "scaled", 0.02)
    if n_super > 0:
        sp["blocks"] = {
            f"pos{i}": stack_specs(block_specs(cfg, k), n_super, "layers")
            for i, k in enumerate(cfg.layer_pattern)
        }
    if n_rem:
        sp["rem"] = {
            f"rem{i}": block_specs(cfg, cfg.layer_pattern[i])
            for i in range(n_rem)
        }
    sp["final_norm"] = layers.norm_specs(cfg)
    if not cfg.tie_embeddings:
        sp["head"] = PSpec((d, v), ("embed", "vocab"), "scaled", 0.02)
    return sp


def compute_params(cfg: ModelConfig, params: dict) -> dict:
    """The tree the forward passes read: every weight the reference casts to
    ``compute_dtype`` inside each call (``.astype(cd)``) cast once here, the
    norms and the leaves the reference reads as float32 left in their own
    dtype: the SSD's ``a_log``, ``dt_bias``, ``d_skip``, ``mamba.norm``
    (``ssm.FLOAT_LEAVES``) and the RG-LRU gates' ``w_a``, ``b_a``, ``w_x``,
    ``b_x``, ``lambda_p`` (``rglru.FLOAT_LEAVES``). A cast is
    deterministic, so the values are the reference's. At a float32
    compute dtype the tree holds the same tensors; at bfloat16 the copies
    cost 2 bytes a parameter on the device."""
    cd = layers.compute_dtype(cfg)

    def walk(node, key, keep):
        if key in _NORMS:
            return node
        if isinstance(node, dict):
            return {k: walk(v, k, _FLOAT_LEAVES.get(key, ()))
                    for k, v in node.items()}
        return node if key in keep else node.to(cd)

    return walk(params, None, ())


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree (views), each leaf unbound once
    (under autograd one node a leaf, whose backward stacks the layers'
    gradients)."""
    # a leaf whose layer dim is sharded (FSDP picks it when it is the
    # largest) is gathered along it first: DTensor cannot unbind it
    flat = {k: _unstack(v, n) if isinstance(v, dict)
            else autoshard.whole_dims(v, 0).unbind(0)
            for k, v in tree.items()}
    return [{k: v[j] for k, v in flat.items()} for j in range(n)]


def _layers(cfg: ModelConfig, tree: dict):
    """(kind, layer tree, stacked index or None, key) of every layer, in
    order: the super-blocks, then the remainder."""
    n_super, n_rem = _pattern_split(cfg)
    for j, blk in enumerate(_unstack(tree["blocks"], n_super)
                            if n_super else []):
        for i, kind in enumerate(cfg.layer_pattern):
            yield kind, blk[f"pos{i}"], j, ("blocks", f"pos{i}")
    for i in range(n_rem):
        yield cfg.layer_pattern[i], tree["rem"][f"rem{i}"], None, ("rem",
                                                                   f"rem{i}")


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def _ffn(cfg, p, h, num_groups):
    """The layer's FFN: (out, router aux loss, or None for a dense MLP)."""
    if cfg.moe is not None:
        return moe.moe_ffn(cfg, p, h, num_groups=num_groups)
    return layers.mlp(cfg, p, h), None


def _gated_ffn(cfg, p, x):
    """A CROSS layer's MLP, ``* tanh(ffn_gate)``."""
    return layers.mlp(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x)) \
        * torch.tanh(p["ffn_gate"].to(x.dtype))


def _need_cross(cross_embeds):
    if cross_embeds is None:
        raise ValueError("CROSS layer requires cross_embeds")
    return cross_embeds


def _gathered(p: dict) -> dict:
    """A layer's parameters, each whole over the data axes (its FSDP
    all-gather; the identity without a mesh)."""
    return {k: _gathered(v) if isinstance(v, dict) else gathered(v)
            for k, v in p.items()}


def _apply_block(cfg, kind, p, x, cross_embeds=None, num_groups=1):
    """One layer over the full sequence. Returns (x, aux loss or None)."""
    p = _gathered(p)
    if kind == SSD:
        return x + ssm.ssd_forward(cfg, p["mamba"],
                                   layers.norm(cfg, p["ln1"], x)), None
    if kind == RGLRU:
        x = x + rglru.rglru_forward(cfg, p["rec"],
                                    layers.norm(cfg, p["ln1"], x))
        return x + layers.mlp(cfg, p["ffn"],
                              layers.norm(cfg, p["ln2"], x)), None
    if kind == CROSS:
        x = x + layers.cross_attention(cfg, p["xattn"],
                                       layers.norm(cfg, p["ln1"], x),
                                       _need_cross(cross_embeds))
        return x + _gated_ffn(cfg, p, x), None
    w = cfg.sliding_window if kind == LOCAL else None
    x = x + layers.self_attention(cfg, p["attn"],
                                  layers.norm(cfg, p["ln1"], x), window=w)
    f, aux = _ffn(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x), num_groups)
    return x + f, aux


def _add_aux(total, aux):
    return total if aux is None else (aux if total is None
                                      else total + aux)


def embed_inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    if cfg.embeds_input:
        return batch["embeds"].to(layers.compute_dtype(cfg))
    return _embed(cfg, params, batch["tokens"])


def _embed(cfg: ModelConfig, params: dict, tokens) -> torch.Tensor:
    """The embedding rows of ``tokens`` in the compute dtype. Under a mesh
    the gather runs on each rank's own rows with the table whole
    (DTensor's index rules mis-handle a sharded table, and the
    reference's GSPMD rejects its own layout here); where the rows split
    over the data axes, the table's gradient is a partial sum over
    them."""
    cd = layers.compute_dtype(cfg)
    n = group_size(DP)
    split = n > 1 and tokens.shape[0] % n == 0
    return local_call(lambda e, t: e[t], (params["embed"].to(cd), tokens),
                      ((None, None), (DP, None)), out_of=1,
                      partial_grads={0: DP} if split else {})


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    # the head's product views [B, S, D] as [B * S, D]: S whole on each rank
    x = hint(layers.norm(cfg, params["final_norm"], x), DP, None, None)
    w = (params["embed"].T if cfg.tie_embeddings else params["head"])
    return (x @ gathered(w.to(x.dtype))).to(layers.acc_dtype(x.dtype))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the matrix products' outputs, recompute the
    rest (batched products, element-wise ops), the counterpart of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` (the
    contractions with no batch dims are ``aten.mm`` here: ``layers._dot``,
    the MLPs and the unembedding)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` rematerialised in the backward per ``cfg.remat`` (none | full
    | dots). As ``jax.checkpoint`` outside a differentiated call, it is
    ``fn`` itself when autograd is off. Remat changes memory only: the
    backward recomputes with the same kernels, so the gradients are the
    same bits."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _super_block(cfg: ModelConfig, num_groups: int, x: torch.Tensor,
                 cross, blk: dict):
    """One repetition of the pattern: (x, the layers' summed aux loss or
    None). Under remat the aux leaves the checkpointed function as an
    output; ``cross`` (the compute-dtype ``cross_embeds`` or None) enters
    it as an argument."""
    aux = None
    x = _shard_stream(x)
    for i, kind in enumerate(cfg.layer_pattern):
        x, a = _apply_block(cfg, kind, blk[f"pos{i}"], x, cross, num_groups)
        aux = _add_aux(aux, a)
    return _shard_stream(x), aux


def _cross_embeds(batch: dict, x: torch.Tensor):
    """The batch's ``cross_embeds`` in x's (the compute) dtype, or None."""
    cross = batch.get("cross_embeds")
    return None if cross is None else cross.to(x.dtype)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            num_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: {tokens|embeds, cross_embeds?}. Runs
    under autograd (training, with ``cfg.remat`` per super-block) or
    without it. ``num_groups`` splits each MoE layer's tokens into
    dispatch groups.

    Returns (logits [B,S,V] f32, aux_loss scalar): the MoE routers' aux
    losses summed over the layers in float32, 0 for the other stacks.
    """
    x = embed_inputs(cfg, params, batch)
    cross = _cross_embeds(batch, x)
    n_super, n_rem = _pattern_split(cfg)
    aux = None
    if n_super > 0:
        body = _maybe_remat(cfg, functools.partial(_super_block, cfg,
                                                   num_groups))
        for blk in _unstack(params["blocks"], n_super):
            x, a = body(x, cross, blk)
            aux = _add_aux(aux, a)
    for i in range(n_rem):
        x, a = _apply_block(cfg, cfg.layer_pattern[i],
                            params["rem"][f"rem{i}"], x, cross, num_groups)
        aux = _add_aux(aux, a)
    x = _shard_stream(x)
    if aux is None:
        aux = torch.zeros((), dtype=layers.acc_dtype(x.dtype),
                          device=x.device)
    return unembed(cfg, params, x), aux


class _VocabCE(torch.autograd.Function):
    """Per-position ``logsumexp(x) - x[label]`` over a vocabulary split
    into blocks, in float32 (float64 logits in float64), on one rank's
    block ``x`` [..., Vb] (columns
    ``lo`` to ``lo + Vb`` of the whole vocabulary): the max, the sum of
    exponentials and the gold logit (each rank's own labels, 0 for the
    others) all-reduced over the mesh dims ``dims`` of ``mesh`` that
    split the vocabulary (no dims: the identity, one block). The
    backward is local, ``(softmax - onehot) * g`` on the block, so no
    gradient flows through a collective."""

    @staticmethod
    def forward(ctx, x, labels, lo, mesh, dims):
        def reduce(t, op):
            return autoshard.all_reduce_over(t, mesh, dims, op)

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        m = reduce(xf.amax(dim=-1), "max")
        # one block-sized temporary a pass (exp in place)
        s = reduce((xf - m[..., None]).exp_().sum(dim=-1), "sum")
        lse = m + torch.log(s)
        labels = labels.long()
        own = (labels >= lo) & (labels < lo + x.shape[-1])
        idx = torch.where(own, labels - lo, 0)
        gold = reduce(torch.where(
            own, torch.gather(xf, -1, idx[..., None])[..., 0], 0.0), "sum")
        ctx.save_for_backward(xf, lse, idx, own)
        ctx.dtype = x.dtype
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        xf, lse, idx, own = ctx.saved_tensors
        grad = (xf - lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(own, -g, 0.0)[..., None])
        return grad.to(ctx.dtype), None, None, None, None


def vocab_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` at every position, in float32
    or the logits' wider dtype (logits [B, S, V], labels [B, S] -> [B, S]).
    Under a mesh each rank
    works on its own rows and its own block of the vocabulary, which
    stays sharded over ``model`` as the head's product leaves it
    (:class:`_VocabCE`); a plain tensor is one block of the same code."""
    logits = hint(logits, DP, None, "model")
    mesh, dims, lo = None, (), 0
    if is_distributed(logits):
        last = logits.dim() - 1
        dims = tuple(i for i, p in enumerate(logits.placements)
                     if p.is_shard(last))
        mesh, lo = logits.device_mesh, autoshard.block(logits)[1][-1]
    return local_call(
        lambda x, lb: _VocabCE.apply(x, lb, lo, mesh, dims),
        (logits, labels), ((DP, None, "model"), (DP, None)), out_of=1)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            num_groups: int = 1) -> tuple[torch.Tensor, dict]:
    """Next-token (or provided-labels) cross-entropy + router aux: the mean
    over positions of ``logsumexp(logits) - logits[label]`` in float32, as
    the reference computes it (no fused cross-entropy), on each rank's own
    block of the vocabulary (:func:`vocab_cross_entropy`). Returns (loss,
    {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch, num_groups=num_groups)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = batch["tokens"][:, 1:]
        logits = logits[:, :-1]
    valid = torch.ones_like(labels, dtype=torch.float32)
    ce = ((vocab_cross_entropy(logits, labels) * valid).sum()
          / torch.clamp_min(valid.sum(), 1.0))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Cache + decode
# ---------------------------------------------------------------------------


def _layer_cache_struct(cfg: ModelConfig, kind: str, batch: int,
                        max_seq: int) -> dict:
    """Cache shapes for one layer: K/V for attention (for CROSS, of the
    ``n_cross_tokens`` modality embeddings), the float32 state ``h`` and
    the compute-dtype conv tail for RG-LRU and SSD."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    cd = layers.compute_dtype(cfg)
    if kind == SSD:
        di, nh, ds, dc = ssm._dims(cfg)
        return {"h": ShapeDtype((batch, nh, cfg.ssm.head_dim, ds),
                                layers.acc_dtype(cd)),
                "conv": ShapeDtype((batch, dc - 1, di + 2 * ds), cd)}
    if kind == RGLRU:
        di, _, _, dc = rglru._dims(cfg)
        return {"h": ShapeDtype((batch, di), layers.acc_dtype(cd)),
                "conv": ShapeDtype((batch, dc - 1, di), cd)}
    if kind == CROSS:
        n = max(cfg.n_cross_tokens, 1)
        return {"ck": ShapeDtype((batch, n, hkv, dh), cd),
                "cv": ShapeDtype((batch, n, hkv, dh), cd)}
    if kind == GLOBAL:
        n = max_seq
    elif kind == LOCAL:
        n = min(cfg.sliding_window, max_seq)
    else:
        raise ValueError(kind)
    return {"k": ShapeDtype((batch, n, hkv, dh), cd),
            "v": ShapeDtype((batch, n, hkv, dh), cd)}


def cache_struct(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Abstract cache tree (ShapeDtype leaves) matching the params tree."""
    n_super, n_rem = _pattern_split(cfg)
    out: dict = {}
    if n_super > 0:
        out["blocks"] = {}
        for i, kind in enumerate(cfg.layer_pattern):
            leaf = _layer_cache_struct(cfg, kind, batch, max_seq)
            out["blocks"][f"pos{i}"] = {
                k: ShapeDtype((n_super,) + s.shape, s.dtype)
                for k, s in leaf.items()}
    if n_rem:
        out["rem"] = {
            f"rem{i}": _layer_cache_struct(cfg, cfg.layer_pattern[i], batch,
                                           max_seq)
            for i in range(n_rem)
        }
    return out


@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """A zero cache on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    return {
        top: {name: {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                     for k, s in leaf.items()}
              for name, leaf in sub.items()}
        for top, sub in cache_struct(cfg, batch, max_seq).items()
    }


def _layer_cache(cache: dict, idx) -> dict:
    """One layer's cache entries (views at layer ``idx`` when stacked; a
    sharded stacked leaf's layer as ``autoshard.layer_of`` gives it)."""
    return cache if idx is None else {k: layer_of(v, idx)
                                      for k, v in cache.items()}


def _put(buf, idx, value) -> None:
    """Layer ``idx`` of a cache leaf (the leaf itself when ``idx`` is None)
    set to ``value`` in place; on a DTensor each rank writes its own
    block."""
    lead = () if idx is None else (idx,)
    write_block(buf, value, lead + (slice(None),) * value.dim())


def _decode_block(cfg, kind, p, x, cache, pos, idx=None, num_groups=1):
    """One layer, one token; the K/V or the recurrent state land in
    ``cache`` (stacked: at layer ``idx``) in place; a CROSS layer reads its
    K/V and writes nothing. Returns x."""
    if kind == SSD:
        c = _layer_cache(cache, idx)
        out, st = ssm.ssd_decode_step(
            cfg, p["mamba"], layers.norm(cfg, p["ln1"], x),
            ssm.SSDState(h=c["h"], conv=c["conv"]))
        _put(cache["h"], idx, st.h)
        _put(cache["conv"], idx, st.conv)
        return x + out
    if kind == RGLRU:
        c = _layer_cache(cache, idx)
        out, st = rglru.rglru_decode_step(
            cfg, p["rec"], layers.norm(cfg, p["ln1"], x),
            rglru.RGLRUState(h=c["h"], conv=c["conv"]))
        _put(cache["h"], idx, st.h)
        _put(cache["conv"], idx, st.conv)
        x = x + out
        return x + layers.mlp(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x))
    if kind == CROSS:
        # cross K/V were projected at prefill; attend directly (read-only)
        c = _layer_cache(cache, idx)
        x = x + layers.cross_attend(cfg, p["xattn"],
                                    layers.norm(cfg, p["ln1"], x),
                                    c["ck"], c["cv"])
        return x + _gated_ffn(cfg, p, x)
    h = layers.norm(cfg, p["ln1"], x)
    a, _, _ = layers.decode_attention_stacked(
        cfg, p["attn"], h, cache["k"], cache["v"], idx, pos,
        local=(kind == LOCAL),
    )
    x = x + a
    f, _ = _ffn(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x), num_groups)
    return x + f


def _serving(params):
    """The autograd context of a serving pass: inference mode, or on
    DTensor parameters no_grad (DTensor's ops cannot run on inference
    tensors)."""
    if any(is_distributed(x) for x in T.leaves(params)):
        return torch.no_grad()
    return torch.inference_mode()


def decode_step(
    cfg: ModelConfig,
    params: dict,
    batch: dict,     # {token: [B,1] int | embeds: [B,1,D], pos: int}
    cache: dict,
    *,
    num_groups: int = 1,
) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole stack. Returns (logits [B,V], cache):
    the cache is updated in place and returned. On DTensor parameters and
    a cache laid out by ``sharding.cache_shardings`` (sharded serving,
    ``launch/dryrun.build_cell``) each rank writes and attends over its
    own block of the cache. ``num_groups`` splits a MoE layer's tokens
    into dispatch groups (the reference's decode uses one)."""
    pos = int(batch["pos"])
    with _serving(params), use_for(params):
        if cfg.embeds_input:
            x = batch["embeds"].to(layers.compute_dtype(cfg))
        elif is_distributed(params["embed"]):
            x = _embed(cfg, params, batch["token"])
        else:
            x = params["embed"].to(layers.compute_dtype(cfg))[batch["token"]]
        for kind, p, idx, (top, name) in _layers(cfg, params):
            x = _decode_block(cfg, kind, p, x, cache[top][name], pos, idx,
                              num_groups)
        return unembed(cfg, params, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# Prefill: forward + cache construction
# ---------------------------------------------------------------------------


def _prefill_block(cfg, kind, p, x, cross, num_groups=1):
    """Layer forward that also returns what its cache keeps: the roped K
    and V [B, S, Hkv, D] of an attention layer, the K and V [B, N, Hkv, D]
    of ``cross`` for a CROSS layer, the final state of an RG-LRU or SSD
    layer (``rglru.RGLRUState``, ``ssm.SSDState``)."""
    if kind == SSD:
        h_in = layers.norm(cfg, p["ln1"], x)
        x = x + ssm.ssd_forward(cfg, p["mamba"], h_in)
        return x, ssm.final_state(cfg, p["mamba"], h_in)
    if kind == RGLRU:
        out, st = rglru.rglru_prefill(cfg, p["rec"],
                                      layers.norm(cfg, p["ln1"], x))
        x = x + out
        x = x + layers.mlp(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x))
        return x, st
    if kind == CROSS:
        k, v = layers._project_kv(cfg, p["xattn"], _need_cross(cross))
        x = x + layers.cross_attend(cfg, p["xattn"],
                                    layers.norm(cfg, p["ln1"], x), k, v)
        return x + _gated_ffn(cfg, p, x), (k, v)
    cd = layers.compute_dtype(cfg)
    w = cfg.sliding_window if kind == LOCAL else None
    h = layers.norm(cfg, p["ln1"], x)
    q, k, v = layers._project_qkv(cfg, p["attn"], h)
    q = layers.rope_local(q, 0, cfg.rope_theta)
    k = layers.rope_local(k, 0, cfg.rope_theta)
    a = layers.attend_local(
        lambda q, k, v: layers.gqa_attention(cfg, q, k, v, window=w), q, k, v)
    x = x + layers._dot(a, p["attn"]["wo"].to(cd), 2)
    f, _ = _ffn(cfg, p["ffn"], layers.norm(cfg, p["ln2"], x), num_groups)
    return x + f, (k, v)


def kv_hint(max_seq: int) -> tuple:
    """The layout of a prompt's K/V [B, S, Hkv, D] before it enters a
    GLOBAL cache (the reference's prefill hint): a long cache (max_seq >=
    4096) shards the sequence over ``model``, a short one head_dim."""
    return ((DP, "model", None, None) if max_seq >= 4096
            else (DP, None, None, "model"))


def _store_prompt(kind, bk, bv, idx, k, v, max_seq: int) -> None:
    """Write a prompt's K/V [B, S, Hkv, D] into layer ``idx`` of a
    stacked (``idx`` None: a layer's) zeroed cache [B, T, Hkv, D]: a
    global cache at positions 0..S-1 (laid out first by :func:`kv_hint`),
    a local one its last T entries at their rotating slots (abs % T). On
    a cache of DTensors each rank writes the positions of its own
    block."""
    lead = () if idx is None else (idx,)
    S, T = k.shape[1], bk.shape[-3]
    if kind == GLOBAL:
        if S > T:
            raise ValueError(f"a {S}-token prompt does not fit a {T}-slot "
                             "cache")
        k, v = hint(k, *kv_hint(max_seq)), hint(v, *kv_hint(max_seq))
        at = range(S)
    else:
        first = max(S - T, 0)
        at = range(S) if not first else [t % T for t in range(first, S)]
        if first:
            k = autoshard.whole_dims(k, 1)[:, first:]
            v = autoshard.whole_dims(v, 1)[:, first:]
    rest = (slice(None),) * 2
    write_block(bk, k, lead + (slice(None), at) + rest)
    write_block(bv, v, lead + (slice(None), at) + rest)


def _new_cache(cfg, x, max_seq: int, mesh, shardings) -> dict:
    """The zero cache a prefill fills: on x's device, or under a mesh laid
    out by ``shardings`` (default: ``cache_shardings`` of the mesh)."""
    if mesh is None:
        return init_cache(cfg, x.shape[0], max_seq, device=x.device)
    from repro_torch.distributed import sharding as shd

    struct = cache_struct(cfg, x.shape[0], max_seq)
    if shardings is None:
        shardings = shd.cache_shardings(struct, mesh, shd.ShardingPolicy())
    return shd.zeros(struct, shardings)


def prefill(
    cfg: ModelConfig,
    params: dict,
    batch: dict,
    max_seq: int,
    *,
    num_groups: int = 1,
    shardings=None,
) -> tuple[torch.Tensor, dict]:
    """Consume the prompt (batch: {tokens|embeds, cross_embeds?}); return
    (last-position logits [B,V], decode cache).

    On DTensor parameters and batch over a ``RankMesh`` (sharded serving)
    the residual stream carries the reference's hint around each
    super-block, and the cache is built laid out by ``shardings`` (a tree
    of NamedSharding; default ``sharding.cache_shardings``), each rank
    writing its own block. ``num_groups`` splits a MoE layer's tokens
    into dispatch groups (the reference's prefill uses one)."""
    last = f"pos{len(cfg.layer_pattern) - 1}"
    with _serving(params), use_for(params) as mesh:
        x = embed_inputs(cfg, params, batch)
        cross = _cross_embeds(batch, x)
        cache = _new_cache(cfg, x, max_seq, mesh, shardings)
        for kind, p, idx, (top, name) in _layers(cfg, params):
            if idx is not None and name == "pos0":
                x = _shard_stream(x)
            x, kept = _prefill_block(cfg, kind, p, x, cross, num_groups)
            if idx is not None and name == last:
                x = _shard_stream(x)
            _keep(kind, cache[top][name], idx, kept, max_seq)
        # The reference unembeds all S positions and keeps the last; the
        # norm and the head act row by row, so unembedding the last row
        # alone gives the same values without the [B, S, V] logits.
        if is_distributed(x):
            x = hint(x, DP, None, None)
        return unembed(cfg, params, x[:, -1:])[:, 0, :], cache


def _keep(kind, cache: dict, idx, kept, max_seq: int) -> None:
    """A prefilled layer's K/V or final state into its cache entries."""
    if kind in (SSD, RGLRU):
        _put(cache["h"], idx, kept.h)
        _put(cache["conv"], idx, kept.conv)
        return
    if kind == CROSS:
        want = cache["ck"].shape[1 if idx is None else 2]
        if kept[0].shape[1] != want:
            raise ValueError(
                f"cross_embeds of {kept[0].shape[1]} tokens for a cache "
                f"of n_cross_tokens = {want}")
        _put(cache["ck"], idx, kept[0])
        _put(cache["cv"], idx, kept[1])
        return
    _store_prompt(kind, cache["k"], cache["v"], idx, *kept, max_seq)


# ---------------------------------------------------------------------------
# The model as a module
# ---------------------------------------------------------------------------


class Transformer(torch.nn.Module):
    """A decoder stack on one device, its tensors registered under the
    reference's parameter paths (``blocks.pos0.attn.wq``, ``rem.rem0.ln1.
    scale``, ``embed``, ...), so ``state_dict()`` keys are those paths.

    ``params`` is a parameter tree (``params.materialize`` or
    ``convert.lm_params_from_numpy``); it is moved to ``device`` (the card
    unless told otherwise). The compute-dtype copies of the weights are
    built once here (:func:`compute_params`) and every pass reads them.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _register(self, model_specs(cfg), params, self.device)
        self.compute = compute_params(cfg, self.params)

    def forward(self, batch: dict, *,
                num_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return forward(self.cfg, self.compute, batch,
                           num_groups=num_groups)

    def prefill(self, batch: dict, max_seq: int):
        return prefill(self.cfg, self.compute, batch, max_seq)

    def decode_step(self, batch: dict, cache: dict):
        return decode_step(self.cfg, self.compute, batch, cache)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        return init_cache(self.cfg, batch, max_seq, device=self.device)


def _register(module: torch.nn.Module, specs: dict, tree: dict, device) -> dict:
    """Register ``tree``'s tensors on ``module`` under the spec tree's keys,
    checking every shape; returns the tree of registered parameters."""
    if set(tree) != set(specs):
        raise ValueError(f"parameter keys {sorted(tree)} differ from the "
                         f"model's {sorted(specs)}")
    out = {}
    for k, spec in specs.items():
        if isinstance(spec, PSpec):
            t = tree[k].to(device)
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"parameter {k}: shape {tuple(t.shape)}, "
                                 f"the model's {spec.shape}")
            param = torch.nn.Parameter(t, requires_grad=False)
            module.register_parameter(k, param)
            out[k] = param
        else:
            sub = torch.nn.Module()
            module.add_module(k, sub)
            out[k] = _register(sub, spec, tree[k], device)
    return out
