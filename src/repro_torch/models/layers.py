"""Transformer building blocks: norms, RoPE, GQA attention, gated MLPs.

Plain functions over explicit parameter dicts (built from the PSpec trees
of :mod:`repro_torch.models.params`), each the twin of the reference's
function of the same name. Attention comes in three temporal modes here:

* full-sequence (prefill and the full forward) with causal or
  sliding-window masks: a dense mask up to ``cfg.attn_chunk`` keys, and the
  streaming-softmax ("flash") forward as a loop over key chunks above it;
* single-token decode against a KV cache, written in place;
* cross-attention over stub modality embeddings (vlm), flamingo-style
  gated: :func:`cross_attention`, and :func:`cross_attend` for keys and
  values already projected (a prefill's, or the decode cache's); above
  ``cfg.attn_chunk`` queries they run in query blocks
  (:class:`_CrossBlocks`).

Numerics follow the reference: parameters in their own dtype, products in
``cfg.compute_dtype``, softmax and norms in float32 (``acc_dtype``: float64
when the compute dtype is float64, a setting the reference never uses and
the chip smoke test uses to evaluate a float32 model's function without
float32 rounding on two devices). Every weight is cast
with ``.to(cd)``, which is free when the caller already holds the
compute-dtype copy (``transformer.compute_params``).

Where a straight translation would go wrong:
* ``jax.nn.gelu`` is the tanh approximation, and JAX evaluates its formula
  op by op in the input's dtype with the constants rounded to it; so does
  :func:`gelu_tanh` (in bfloat16, ``F.gelu(approximate="tanh")`` rounds
  once, with exact constants, and differs in the last bits); likewise
  :func:`silu`'s sigmoid in bfloat16;
* ``jnp.mod`` is a floor mod; ``torch.remainder`` (and Python's ``%``) is too;
* rope's frequencies are ``exp(-log(theta) * arange(half) / half)`` in
  float32, not ``theta ** (...)``, computed on the host for every device;
* the dense path divides the scores by ``sqrt(D)``, the flash path multiplies
  them by ``1 / sqrt(D)``;
* ``dynamic_update_slice`` clamps an index out of range; the cache writes
  here raise instead;
* the streaming-softmax path differentiates through its own backward
  (``_Flash``, the reference's ``custom_vjp``), not through the forward's
  ops.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import autoshard
from repro_torch.models.params import PSpec

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Where the reference computes in float32 (norms, scores, softmax,
    rope's angles, logits): float32, or float64 for float64 inputs."""
    return torch.promote_types(dtype, _F32)


def _scalar(value, dtype, device) -> torch.Tensor:
    """A scalar made on ``device`` (a fill, not a copy that waits for the
    stream). A divisor there divides: CUDA turns division by a host scalar
    into a product with its reciprocal."""
    return torch.full((), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Param spec builders
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": PSpec((d,), ("embed",), "ones"),
                "bias": PSpec((d,), ("embed",), "zeros")}
    return {"scale": PSpec((d,), ("embed",), "ones")}


def attention_specs(cfg: ModelConfig, *, gated: bool = False) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    sp = {
        "wq": PSpec((d, hq, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((hq, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = PSpec((hq, dh), ("heads", "head_dim"), "zeros")
        sp["bk"] = PSpec((hkv, dh), ("kv_heads", "head_dim"), "zeros")
        sp["bv"] = PSpec((hkv, dh), ("kv_heads", "head_dim"), "zeros")
    if gated:
        sp["gate"] = PSpec((), (), "zeros")  # tanh-gated residual, init 0
    return sp


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": PSpec((d, f), ("embed", "ff")),
            "w_up": PSpec((d, f), ("embed", "ff")),
            "w_down": PSpec((f, d), ("ff", "embed")),
        }
    return {
        "w_up": PSpec((d, f), ("embed", "ff")),
        "w_down": PSpec((f, d), ("ff", "embed")),
    }


# ---------------------------------------------------------------------------
# Forward ops
# ---------------------------------------------------------------------------


def norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6)
        out = out * p["scale"].to(acc) + p["bias"].to(acc)
    else:
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"].to(acc)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """rope's frequencies ``exp(-log(theta) * arange(half) / half)``,
    computed in float32 on the host and copied to ``device`` once. CUDA's
    ``expf`` and the CPU's ``exp`` differ in the last bit of some of
    these, and the angle ``pos * freq`` carries that error times the
    position; this way every device rotates by the same angles."""
    with torch.inference_mode(False):
        freqs = torch.exp(
            -torch.log(torch.tensor(theta, dtype=_F32))
            * torch.arange(0, half, dtype=_F32)
            / torch.tensor(half, dtype=_F32))
        return freqs.to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D]; positions: [..., S] or [S]."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    acc = acc_dtype(x.dtype)
    ang = positions[..., :, None].to(acc) * freqs.to(acc)  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1
    ).to(x.dtype)


def rope_local(x: torch.Tensor, start: int, theta: float) -> torch.Tensor:
    """:func:`rope` of x [B, S, H, D] at positions ``start .. start + S - 1``
    (made where it runs); under a mesh on each rank's own rows and heads,
    the sequence whole (:func:`autoshard.local_call`)."""
    def one(t):
        pos = torch.arange(t.shape[1], device=t.device) + start
        return rope(t, pos, theta)

    return autoshard.local_call(one, (x,), ((autoshard.DP, None, "model",
                                             None),))


def _dot(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """The contraction of x's last ``n_in`` dims with w's first ``n_in`` (an
    einsum with no batch dims), as one matrix product (``aten.mm``, which
    the ``remat="dots"`` policy saves; ``torch.einsum`` would lower it to
    a batched product over a batch of one)."""
    # the view merges x's lead dims: none but the first may be sharded
    x = autoshard.whole_dims(x, *range(1, x.dim() - n_in))
    lead, tail = x.shape[:x.dim() - n_in], w.shape[n_in:]
    w2 = w.reshape(-1, int(np.prod(tail, dtype=np.int64)))
    return autoshard.pin((x.reshape(*lead, w2.shape[0]) @ w2)
                         .reshape(*lead, *tail))


def _project_q(cfg, p, x):
    """q: [B,S,Hq,D]."""
    cd = compute_dtype(cfg)
    q = _dot(x.to(cd), p["wq"].to(cd), 1)
    return q + p["bq"].to(cd) if "bq" in p else q


def _project_kv(cfg, p, xkv):
    """k,v: [B,T,Hkv,D]."""
    cd = compute_dtype(cfg)
    k = _dot(xkv.to(cd), p["wk"].to(cd), 1)
    v = _dot(xkv.to(cd), p["wv"].to(cd), 1)
    if "bk" in p:
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return k, v


def _project_qkv(cfg, p, x, xkv=None):
    """q: [B,S,Hq,D]; k,v: [B,T,Hkv,D] (xkv defaults to x)."""
    return (_project_q(cfg, p, x),
            *_project_kv(cfg, p, x if xkv is None else xkv))


def _gqa_scores_out(cfg, q, k, v, mask):
    """Grouped-query attention core. mask: [B or 1, 1, S, T] additive f32.
    The head counts are the tensors' (a rank's own heads under a mesh)."""
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    B, S, D = q.shape[0], q.shape[1], q.shape[-1]
    qg = q.reshape(B, S, hkv, g, D)
    acc = acc_dtype(q.dtype)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(acc)
    scores = scores / torch.sqrt(_scalar(D, acc, q.device))
    scores = scores + mask[:, :, None, :, :]  # [B,kv,g,S,T]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, hq, D)


def _chunk_mask(S: int, j: int, chunk: int, window: Optional[int], device):
    """Validity of (query i, key j*chunk+t) pairs. [S, chunk] bool."""
    qi = torch.arange(S, device=device)
    kpos = j * chunk + torch.arange(chunk, device=device)
    ok = kpos[None, :] <= qi[:, None]
    if window is not None:
        ok &= (qi[:, None] - kpos[None, :]) < window
    return ok


def _flash_fwd_impl(q, k, v, window: Optional[int], chunk: int):
    """Streaming-softmax forward, one key chunk at a time.
    q:[B,S,Hq,D], k/v:[B,S,Hkv,D]. Returns (out [B,S,Hq,D], lse
    [B,Hkv,g,S] f32)."""
    cd = q.dtype
    dev = q.device
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, S, hkv, g, D)
    f = acc_dtype(cd)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=f))

    m = torch.full((B, hkv, g, S), -torch.inf, dtype=f, device=dev)
    l = torch.zeros((B, hkv, g, S), dtype=f, device=dev)
    acc = torch.zeros((B, hkv, g, S, D), dtype=f, device=dev)
    for j in range(S // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        # one float32 [B, hkv, g, S, chunk] block, overwritten in place:
        # the scores, the masked scores, then the probabilities
        s = torch.einsum("bskgd,btkd->bkgst", qg, kj).to(f)
        ok = _chunk_mask(S, j, chunk, window, dev)
        s.mul_(scale).masked_fill_(~ok, -torch.inf)

        m_new = torch.maximum(m, s.amax(dim=-1))
        live = ~torch.isinf(m_new)   # fully-masked prefix guard (window warmup)
        p = s.sub_(m_new[..., None]).exp_().masked_fill_(~live[..., None], 0.0)
        r = torch.where(live & ~torch.isinf(m), torch.exp(m - m_new), 0.0)
        l.mul_(r).add_(p.sum(dim=-1))
        pc = p.to(cd)
        # each block is freed as soon as it is read: the float32 one
        # before the product, none left when the next scores are made
        del s, p
        pv = torch.einsum("bkgst,btkd->bkgsd", pc, vj)
        del pc
        acc.mul_(r[..., None]).add_(pv.to(f))
        del pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, hq, D)
    return out.to(cd), lse


class _Flash(torch.autograd.Function):
    """Streaming-softmax attention with the reference's custom backward
    (``_flash_fn`` of ``repro/models/layers.py``): the backward recomputes
    each key chunk's probabilities from the saved logsumexp, never storing
    the [S, chunk] score tiles of every chunk, and its casts are the
    reference's.

    Autograd does not differentiate :func:`_flash_fwd_impl` itself: that
    would keep every chunk's tiles, and in the rows whose first chunks are
    all masked (a LOCAL layer's window warm-up) the discarded branch
    ``exp(-inf - -inf)`` is NaN, whose gradient 0 * NaN only the mask's
    ``where`` stops.

    Both directions overwrite each chunk's blocks in place, as the
    reference's ``lax.scan`` step reuses its buffers: the forward holds
    one float32 [B, Hkv, G, S, chunk] block and one compute-dtype block,
    the backward at most two float32 blocks, one compute-dtype block and
    one float32 dq; the values are the out-of-place ops' bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, window: Optional[int], chunk: int):
        out, lse = _flash_fwd_impl(q, k, v, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        window, chunk = ctx.window, ctx.chunk
        cd = q.dtype
        dev = q.device
        B, S, hq, D = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        f = acc_dtype(cd)
        scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=f))
        qg = q.reshape(B, S, hkv, g, D)
        dog = do.reshape(B, S, hkv, g, D)
        og = out.reshape(B, S, hkv, g, D)
        # D_row = sum_d do * o   [B,hkv,g,S]
        Drow = torch.einsum("bskgd,bskgd->bkgs", dog.to(f), og.to(f))

        dq = torch.zeros((B, S, hkv, g, D), dtype=f, device=dev)
        dk = torch.empty((B, S, hkv, D), dtype=cd, device=dev)
        dv = torch.empty((B, S, hkv, D), dtype=cd, device=dev)
        for j in range(S // chunk):
            sl = slice(j * chunk, (j + 1) * chunk)
            kj, vj = k[:, sl], v[:, sl]
            # at most two float32 [B, hkv, g, S, chunk] blocks (p, then dp
            # turned into ds in place) and one compute-dtype block live
            p = torch.einsum("bskgd,btkd->bkgst", qg, kj).to(f)
            ok = _chunk_mask(S, j, chunk, window, dev)
            p.mul_(scale).sub_(lse[..., None]).exp_().masked_fill_(~ok, 0.0)
            pc = p.to(cd)
            dv[:, sl] = torch.einsum("bkgst,bskgd->btkd", pc, dog)
            del pc
            ds = torch.einsum("bskgd,btkd->bkgst", dog, vj).to(f)
            # p * (dp - Drow) * scale: IEEE products commute
            ds.sub_(Drow[..., None]).mul_(p).mul_(scale)
            del p
            dsc = ds.to(cd)
            del ds
            dq.add_(torch.einsum("bkgst,btkd->bskgd", dsc, kj).to(f))
            dk[:, sl] = torch.einsum("bkgst,bskgd->btkd", dsc, qg)
            del dsc
        return dq.to(cd).reshape(B, S, hq, D), dk, dv, None, None


def gqa_attention(cfg, q, k, v, *, window: Optional[int]):
    """Full-sequence GQA dispatch: dense mask up to the chunk threshold,
    the streaming-softmax attention (custom backward) above it."""
    S = q.shape[1]
    chunk = cfg.attn_chunk
    if S > chunk and S % chunk == 0:
        return _Flash.apply(q, k, v, window, chunk)
    mask = causal_mask(S, S, window=window, device=q.device)
    return _gqa_scores_out(cfg, q, k, v, mask)


def causal_mask(S: int, T: int, offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """Additive mask [1,1,S,T]: query i attends keys j with
    j <= i+offset and (window is None or i+offset - j < window)."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= (qi - kj) < window
    return _additive(ok)[None, None]


def _additive(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, -inf elsewhere, float32."""
    zero = torch.zeros((), dtype=_F32, device=ok.device)
    return torch.where(ok, zero, -torch.inf)


def self_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,               # [B, S, D]
    *,
    window: Optional[int] = None,
    pos_offset: int = 0,
) -> torch.Tensor:
    """Full-sequence causal (optionally sliding-window) self-attention."""
    cd = compute_dtype(cfg)
    S = x.shape[1]
    q, k, v = _project_qkv(cfg, p, x)

    def core(q, k, v):
        pos = torch.arange(S, device=q.device) + pos_offset
        return gqa_attention(cfg, rope(q, pos, cfg.rope_theta),
                             rope(k, pos, cfg.rope_theta), v, window=window)

    out = attend_local(core, q, k, v)
    return _dot(out, p["wo"].to(cd), 2)


def attend_local(core, q, k, v):
    """``core(q, k, v)`` (rope and attention over [B, S, H, D]) on each
    rank's own batch rows and heads under a mesh, on local tensors
    (:func:`autoshard.local_call`): the rows over the data axes, the
    heads over ``model`` when both head counts divide it, or the query
    heads alone when there is one kv head (every rank reads it whole, so
    its gradient sums over ``model``); else the heads stay whole. Without
    a mesh it is ``core(q, k, v)``."""
    mesh = autoshard.current_mesh()
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    hq, hkv = q.shape[2], k.shape[2]
    split = m > 1 and hq % m == 0 and (hkv % m == 0 or hkv == 1)
    kv_split = split and hkv % m == 0
    q_ax = (autoshard.DP, None, "model" if split else None, None)
    kv_ax = (autoshard.DP, None, "model" if kv_split else None, None)
    partial = {1: ("model",), 2: ("model",)} if split and not kv_split else {}
    return autoshard.local_call(core, (q, k, v), (q_ax, kv_ax, kv_ax),
                                partial_grads=partial)


def _check_index(i: int, n: Optional[int], what: str) -> None:
    """Raise where ``dynamic_update_slice`` would clamp: i outside [0, n)
    (n None: no upper end)."""
    if i < 0 or (n is not None and i >= n):
        raise IndexError(f"{what} {i} is outside [0, {n})")


def _decode_qkv(cfg, p, x, pos: int):
    q, k, v = _project_qkv(cfg, p, x)
    if autoshard.is_distributed(q):
        return (rope_local(q, pos, cfg.rope_theta),
                rope_local(k, pos, cfg.rope_theta), v)
    at = torch.full((1,), pos, device=x.device)
    return (rope(q, at, cfg.rope_theta), rope(k, at, cfg.rope_theta), v)


def _decode_out(cfg, p, q, ck, cv, ok):
    cd = compute_dtype(cfg)
    mask = _additive(ok)[None, None, None]
    out = _gqa_scores_out(cfg, q, ck.to(cd), cv.to(cd), mask)
    return _dot(out, p["wo"].to(cd), 2)


def decode_self_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,        # [B, 1, D] — the new token
    cache_k: torch.Tensor,  # [B, S_max, Hkv, Dh]
    cache_v: torch.Tensor,
    pos: int,               # index of the new token
    *,
    window: Optional[int] = None,
):
    """One decode step: write K/V at ``pos`` (in place), attend to the
    valid prefix. Returns (out, cache_k, cache_v)."""
    q, k, v = _decode_qkv(cfg, p, x, pos)
    T = cache_k.shape[1]
    _check_index(pos, T, "decode position")
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    kj = torch.arange(T, device=x.device)
    ok = kj <= pos
    if window is not None:
        ok &= (pos - kj) < window
    return _decode_out(cfg, p, q, cache_k, cache_v, ok), cache_k, cache_v


def _window_ok(pos: int, W: int, device) -> torch.Tensor:
    """Slot s of a rotating window cache holds the key of absolute position
    pos - ((pos - s) mod W) (a floor mod); it is valid once that is >= 0."""
    slots = torch.arange(W, device=device)
    return (pos - torch.remainder(pos - slots, W)) >= 0


def decode_local_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,        # [B, 1, D]
    cache_k: torch.Tensor,  # [B, W, Hkv, Dh] rotating window cache
    cache_v: torch.Tensor,
    pos: int,               # ABSOLUTE position of the new token
):
    """Sliding-window decode against a rotating cache (slot = pos % W),
    written in place.

    Keys were RoPE'd at their absolute positions when written; a slot s holds
    the key for absolute position  pos - ((pos - s) mod W),  which is negative
    (=> masked) until the window has warmed up.
    """
    W = cache_k.shape[1]
    q, k, v = _decode_qkv(cfg, p, x, pos)
    _check_index(pos, None, "decode position")
    slot = pos % W
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    ok = _window_ok(pos, W, x.device)
    return _decode_out(cfg, p, q, cache_k, cache_v, ok), cache_k, cache_v


def decode_attention_stacked(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,          # [B, 1, D]
    buf_k: torch.Tensor,      # [L, B, S|W, Hkv, Dh] (idx given) or unstacked
    buf_v: torch.Tensor,
    idx: Optional[int],       # layer index into the stacked dim, or None
    pos: int,                 # absolute position of the new token
    *,
    local: bool,
):
    """One decode step writing the new K/V **in place into the (stacked)
    cache buffer** at layer ``idx``. Returns (out, buf_k, buf_v).

    Global attention masks keys beyond `pos`; local attention uses a rotating
    window buffer (slot = pos % W) with absolute-position masking. On a
    cache of DTensors the new K/V land in the blocks that hold the slot
    and each rank attends over its own block (:func:`attend_cache`).
    """
    q, k, v = _decode_qkv(cfg, p, x, pos)
    if idx is not None:
        _check_index(idx, buf_k.shape[0], "layer index")
    lead = () if idx is None else (idx,)
    rest = (slice(None),) * 2
    W = buf_k.shape[-3]
    _check_index(pos, None if local else W, "decode position")
    at = pos % W if local else pos
    autoshard.write_block(buf_k, k, lead + (slice(None), range(at, at + 1))
                          + rest)
    autoshard.write_block(buf_v, v, lead + (slice(None), range(at, at + 1))
                          + rest)
    ck = buf_k if idx is None else autoshard.layer_of(buf_k, idx)
    cv = buf_v if idx is None else autoshard.layer_of(buf_v, idx)
    dev = (q.to_local() if autoshard.is_distributed(q) else q).device
    ok = (_window_ok(pos, W, dev) if local
          else torch.arange(W, device=dev) <= pos)
    return (_dot(attend_cache(cfg, q, ck, cv, ok),
                 p["wo"].to(compute_dtype(cfg)), 2), buf_k, buf_v)


def attend_cache(cfg, q, ck, cv, ok: torch.Tensor) -> torch.Tensor:
    """One query position q [B, 1, Hq, D] attending a cache ck, cv [B, T,
    Hkv, D] with key validity ``ok`` [T] (a plain bool tensor over the
    whole sequence). Returns [B, 1, Hq, D].

    On a cache of DTensors laid out by ``sharding.cache_shardings``
    (batch over the data axes; a long cache's sequence, or a short one's
    head_dim, over ``model``) each rank attends over its own block of the
    cache, never gathering it; a plain cache is the one block. A rank
    whose block is a slice of the sequence computes the softmax's parts
    over its keys: the local max, then, after the max over the sequence's
    ranks, its sum of exponentials and its weighted values, which those
    ranks sum. A rank holding a slice of head_dim computes a partial q.k,
    which the ranks of that dim sum before the softmax, and the slice of
    the output its values give. The output's heads are over ``model``
    where they divide."""
    cd = q.dtype if not autoshard.is_distributed(q) else q.to_local().dtype
    if autoshard.is_distributed(ck):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, pl = ck.device_mesh, ck.placements
        n = mesh.ndim
        seq = [i for i in range(n) if pl[i].is_shard(1)]
        hd = [i for i in range(n) if pl[i].is_shard(3)]
        bat = [i for i in range(n) if pl[i].is_shard(0)]
        lay = [Shard(0) if i in bat else Shard(3) if i in hd
               else Replicate() for i in range(n)]
        ql = q.redistribute(mesh, lay).to_local()
        kl, vl = ck.to_local(), cv.to_local()
        (_, tl, _, _), (_, t0, _, _) = autoshard.block(ck)
        okl = ok[t0:t0 + tl]
    else:
        mesh, seq, hd = None, [], []
        ql, kl, vl, okl = q, ck, cv, ok
    acc = acc_dtype(cd)
    B, S, hq, Dl = ql.shape
    hkv = kl.shape[2]
    g = hq // hkv
    qg = ql.reshape(B, S, hkv, g, Dl)
    if hd:
        # partial products over the rank's slice of head_dim, summed
        s = torch.einsum("bskgd,btkd->bkgst", qg.to(acc), kl.to(acc))
        s = autoshard.all_reduce_over(s, mesh, hd, "sum")
    else:
        s = torch.einsum("bskgd,btkd->bkgst", qg, kl.to(cd)).to(acc)
    s = s / torch.sqrt(_scalar(q.shape[-1], acc, ql.device))
    s = s + _additive(okl)
    m = autoshard.all_reduce_over(s.amax(dim=-1, keepdim=True), mesh, seq,
                                  "max")
    e = torch.exp(s - m)
    den = autoshard.all_reduce_over(e.sum(dim=-1, keepdim=True), mesh, seq,
                                    "sum")
    w = (e / den).to(cd)
    if seq:
        # each rank's share of the weighted values, summed in float32
        o = torch.einsum("bkgst,btkd->bskgd", w.to(acc), vl.to(acc))
        o = autoshard.all_reduce_over(o, mesh, seq, "sum").to(cd)
    else:
        o = torch.einsum("bkgst,btkd->bskgd", w, vl.to(cd))
    o = o.reshape(B, S, hq, Dl)
    if mesh is None:
        return o
    out = DTensor.from_local(o, mesh, lay, run_check=False, shape=q.shape,
                             stride=q.stride())
    # head_dim whole again, the heads over model (the layout ``wo``'s
    # product reads)
    out = autoshard.whole_dims(out, 3)
    return autoshard.hint(out, autoshard.DP, None, "model", None)


class _CrossBlocks(torch.autograd.Function):
    """Attention with no mask (a zero one), the queries ``cfg.attn_chunk``
    rows at a time (the last block shorter where that does not divide S).
    Each block runs :func:`_gqa_scores_out`'s ops, so each output row is
    the dense path's; no [S, N] score tensor is ever whole, and only q, k
    and v are saved. The backward recomputes each block's softmax and
    applies the chain rule autograd applies to the dense path (the
    weighted sum's product, the casts, ``_softmax_backward_data``, the
    division, the scores' product), summing dk and dv over the blocks in
    the accumulation dtype."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: ModelConfig):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = cfg
        bs = cfg.attn_chunk
        mask = _cross_mask(q, k, bs)
        out = torch.empty_like(q)
        for i in range(0, q.shape[1], bs):
            qi = q[:, i:i + bs]
            out[:, i:i + bs] = _gqa_scores_out(cfg, qi, k, v,
                                               mask[:, :, :qi.shape[1]])
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        bs = ctx.cfg.attn_chunk
        B, S, hq, D = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        cd, dev = q.dtype, q.device
        acc = acc_dtype(cd)
        root = torch.sqrt(_scalar(D, acc, dev))
        mask = _cross_mask(q, k, bs)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=acc, device=dev)
        dv = torch.zeros(v.shape, dtype=acc, device=dev)
        for i in range(0, S, bs):
            n = min(bs, S - i)
            qg = q[:, i:i + n].reshape(B, n, hkv, g, D)
            dog = do[:, i:i + n].reshape(B, n, hkv, g, D)
            s = torch.einsum("bskgd,btkd->bkgst", qg, k).to(acc)
            s.div_(root).add_(mask[:, :, None, :n])
            w = torch.softmax(s, dim=-1)
            del s
            wc = w.to(cd)
            dv.add_(torch.einsum("bkgst,bskgd->btkd", wc, dog).to(acc))
            del wc
            dw = torch.einsum("bskgd,btkd->bkgst", dog, v).to(acc)
            ds = torch._softmax_backward_data(dw, w, -1, acc)
            del dw, w
            dsc = ds.div_(root).to(cd)
            del ds
            dq[:, i:i + n] = torch.einsum("bkgst,btkd->bskgd", dsc,
                                          k).reshape(B, n, hq, D)
            dk.add_(torch.einsum("bkgst,bskgd->btkd", dsc, qg).to(acc))
            del dsc
        return dq, dk.to(cd), dv.to(cd), None


def _cross_mask(q, k, rows: int) -> torch.Tensor:
    """The zero additive mask [1, 1, rows, N] of a block of queries."""
    return torch.zeros((1, 1, min(rows, q.shape[1]), k.shape[1]), dtype=_F32,
                       device=q.device)


def cross_attend(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The gated cross-attention of queries from ``x`` [B, S, D] over
    projected keys and values [B, N, Hkv, D]: no rope, no mask (a zero
    one), then ``wo`` and ``* tanh(gate)``. Above ``cfg.attn_chunk``
    queries (training, prefill) the scores run in query blocks
    (:class:`_CrossBlocks`); a decode step's one query, and any S up to
    the chunk, take the dense path."""
    cd = compute_dtype(cfg)

    def core(q, k, v):
        if q.shape[1] > cfg.attn_chunk:
            return _CrossBlocks.apply(q, k.to(cd), v.to(cd), cfg)
        return _gqa_scores_out(cfg, q, k.to(cd), v.to(cd),
                               _cross_mask(q, k, q.shape[1]))

    out = attend_local(core, _project_q(cfg, p, x), k, v)
    return _dot(out, p["wo"].to(cd), 2) * torch.tanh(p["gate"].to(cd))


def cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,         # [B, S, D] queries (text stream)
    cross_kv: torch.Tensor,  # [B, N, D] stub modality embeddings
) -> torch.Tensor:
    """Gated cross-attention (flamingo-style: tanh(gate) starts at 0)."""
    return cross_attend(cfg, p, x, *_project_kv(cfg, p, cross_kv))


def _const(value: float, x: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to x's dtype, as a host scalar (no launch)."""
    return torch.tensor(value, dtype=x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (approximate=True) as JAX computes it: one op at
    a time in x's dtype, each result rounded to it, the constants too."""
    x3 = (x * x) * x
    inner = _const(np.sqrt(2 / np.pi), x) * (x + _const(0.044715, x) * x3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


class _LogisticBF16(torch.autograd.Function):
    """XLA's bfloat16 logistic: 1 / (1 + exp(-x)), each op's result
    rounded to bfloat16, with JAX's derivative g * (ans * (1 - ans)).
    Autograd through the expansion itself would give 0 * inf = NaN where
    exp(-x) overflows (x below about -88)."""

    @staticmethod
    def forward(ctx, x):
        # in place on one buffer: four launches, no temporary beyond the
        # result (1 / t would be two launches, reciprocal and a multiply)
        ans = x.neg().exp_().add_(1).reciprocal_()
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x). In bfloat16 the sigmoid is
    evaluated as XLA's compiler expands its logistic op (``_LogisticBF16``;
    ``torch.sigmoid`` rounds once and differs in the last bit of about
    3% of bfloat16 inputs); in float32 the two agree within an ulp and
    ``torch.sigmoid`` is one op."""
    if x.dtype == torch.bfloat16:
        return x * _LogisticBF16.apply(x)
    return x * torch.sigmoid(x)


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = compute_dtype(cfg)
    # the products view [B, S, D] as [B * S, D]: S whole on each rank
    xc = autoshard.whole_dims(x.to(cd), *range(1, x.dim() - 1))
    if cfg.act in ("swiglu", "geglu"):
        g = xc @ p["w_gate"].to(cd)
        u = xc @ p["w_up"].to(cd)
        g = silu(g) if cfg.act == "swiglu" else gelu_tanh(g)
        return autoshard.pin((g * u) @ p["w_down"].to(cd))
    h = gelu_tanh(xc @ p["w_up"].to(cd))
    return autoshard.pin(h @ p["w_down"].to(cd))
