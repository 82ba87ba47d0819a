"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060], the twin of
the reference's ``models/ssm.py``.

Training and prefill use the chunked SSD algorithm: the sequence is split
into chunks; within a chunk the output is the masked quadratic
(attention-like) form, across chunks a [heads, head_dim, d_state] state is
carried by a triangular product over the chunks. Decode carries the same
state one token at a time (:func:`ssd_decode_step`).

Numerics follow the reference: products in ``cfg.compute_dtype``, the
decays, the state and the gated norm in float32 (``layers.acc_dtype``:
float64 at a float64 compute dtype). The reference streams the
intra-chunk decay plane over blocks of 8 heads to keep it VMEM-sized on a
TPU; that changes no element's arithmetic, so the port computes all heads
at once. Its bfloat16 products with ``preferred_element_type=float32``
are computed here on float32 copies of the bfloat16 operands (the
products of two bfloat16 numbers are exact in float32, and the sums are
float32 in both). Under a mesh the chunk views and the inter-chunk states
carry the reference's hints (the chunks over ``model``, the batch over
the data axes) and the causal conv runs on each rank's own rows and
channels; without a mesh they are no-ops.

Where the port departs from a straight translation:
* the masked exponentials (the intra-chunk decay plane, the inter-chunk
  decay matrix) exponentiate ``where(mask, x, -inf)`` in place of
  ``where(mask, exp(x), 0)``. The values are the same bits (exp(-inf) is
  0), but above the diagonal ``x`` is a growing sum of positive terms
  whose ``exp`` overflows to inf at full width, and the gradient of the
  reference's form there is 0 * inf = NaN. The port's is 0.
* ``jax.nn.softplus`` is ``logaddexp(x, 0)`` (``torch.logaddexp``), not
  ``F.softplus`` with its threshold.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import DP, hint
from repro_torch.models import layers
from repro_torch.models.params import PSpec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return di, nh, s.d_state, s.d_conv


def ssd_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, nh, ds, dc = _dims(cfg)
    conv_dim = di + 2 * ds  # conv runs over x, B, C streams
    return {
        "in_proj": PSpec((d, 2 * di + 2 * ds + nh), ("embed", "inner")),
        "conv_w": PSpec((dc, conv_dim), ("conv", "inner"), "scaled", 0.1),
        "conv_b": PSpec((conv_dim,), ("inner",), "zeros"),
        "a_log": PSpec((nh,), ("ssm_heads",), "zeros"),
        "dt_bias": PSpec((nh,), ("ssm_heads",), "zeros"),
        "d_skip": PSpec((nh,), ("ssm_heads",), "ones"),
        "norm": PSpec((di,), ("inner",), "ones"),
        "out_proj": PSpec((di, d), ("inner", "embed")),
    }


# The leaves the reference reads as float32 in every call (the decay, the
# step bias, the skip and the gated norm's scale): serving keeps them in
# their own dtype (``transformer.compute_params``).
FLOAT_LEAVES = ("a_log", "dt_bias", "d_skip", "norm")


class SSDState(NamedTuple):
    """Decode-time recurrent state for one SSD layer."""

    h: torch.Tensor          # [B, nh, hd, ds] ssm state (float32)
    conv: torch.Tensor       # [B, d_conv-1, conv_dim] causal-conv tail


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device=None) -> SSDState:
    di, nh, ds, dc = _dims(cfg)
    hd = cfg.ssm.head_dim
    return SSDState(
        h=torch.zeros((batch, nh, hd, ds), dtype=dtype, device=device),
        conv=torch.zeros((batch, dc - 1, di + 2 * ds), dtype=dtype,
                         device=device),
    )


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) along the last dim."""
    di, nh, ds, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, ds, ds, nh], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(cfg: ModelConfig, p: dict, xbc: torch.Tensor,
                 conv_tail=None):
    """Depthwise causal conv over the sequence. xbc: [B, S, conv_dim].
    Returns (silu(conv + bias), the last d_conv - 1 inputs). Under a mesh
    on each rank's own rows and channels, the sequence whole."""
    C = xbc.shape[-1]
    ch = "model" if C % autoshard.group_size(("model",)) == 0 else None
    n = autoshard.group_size(autoshard.DP)
    split = n > 1 and xbc.shape[0] % n == 0
    ins = (xbc, p["conv_w"], p["conv_b"])
    axes = ((autoshard.DP, None, ch), (None, ch), (ch,))
    if conv_tail is not None:
        ins, axes = ins + (conv_tail,), axes + ((autoshard.DP, None, ch),)
    return autoshard.local_call(
        lambda x, w, b, *t: _conv(cfg, w, b, x, t[0] if t else None),
        ins, axes, partial_grads={1: autoshard.DP, 2: autoshard.DP}
        if split else {})


def _conv(cfg: ModelConfig, conv_w, conv_b, xbc, conv_tail):
    dc = cfg.ssm.d_conv
    if conv_tail is None:
        pad = torch.zeros((xbc.shape[0], dc - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    # the reference's order: a Python sum from 0 over the shifted products
    out = sum(xp[:, i:i + S, :] * conv_w[i].to(xbc.dtype)
              for i in range(dc))
    out = out + conv_b.to(xbc.dtype)
    new_tail = xp[:, xp.shape[1] - (dc - 1):, :]
    return layers.silu(out), new_tail


def _masked_exp(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """exp(x) where ``mask``, 0 elsewhere, with a 0 gradient there."""
    return torch.exp(torch.where(autoshard.replicated_like(mask, x), x,
                                 -torch.inf))


def _gated_norm_out(cfg: ModelConfig, p: dict, y: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """mamba2's gated RMSNorm, norm(y * silu(z)), then out_proj."""
    cd = layers.compute_dtype(cfg)
    f = layers.acc_dtype(cd)
    y = y * layers.silu(z)
    yf = y.to(f)
    y = (yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6)
         * p["norm"].to(f)).to(cd)
    return layers._dot(y, p["out_proj"].to(cd), 1)


def _chunks(x: torch.Tensor, n: int, q: int) -> torch.Tensor:
    """x [B, S, ...] viewed as [B, n, q, ...]; a sequence sharded over
    more ranks than divide n is made whole first (a view cannot split a
    dim sharded unevenly)."""
    if autoshard.is_distributed(x):
        ranks = 1
        for i, p in enumerate(x.placements):
            if p.is_shard(1):
                ranks *= x.device_mesh.size(i)
        if n % ranks:
            x = autoshard.whole_dims(x, 1)
    return x.reshape(x.shape[0], n, q, *x.shape[2:])


def ssd_forward(cfg: ModelConfig, p: dict, xin: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD (training / prefill). xin: [B, S, D] -> [B, S, D]."""
    cd = layers.compute_dtype(cfg)
    f = layers.acc_dtype(cd)
    di, nh, ds, _ = _dims(cfg)
    hd = cfg.ssm.head_dim
    Q = cfg.ssm.chunk
    B_, S, _ = xin.shape
    if not (S % Q == 0 or S < Q):
        raise ValueError(f"sequence length {S} is neither below nor a "
                         f"multiple of the SSD chunk {Q}")
    Qe = min(Q, S)
    n = max(1, S // Qe)
    dev = xin.device

    zxbcdt = layers._dot(xin.to(cd), p["in_proj"].to(cd), 1)
    z, x, Bmat, Cmat, dt = _split_proj(cfg, zxbcdt)
    xbc, _ = _causal_conv(cfg, p, torch.cat([x, Bmat, Cmat], dim=-1))
    x, Bmat, Cmat = torch.split(xbc, [di, ds, ds], dim=-1)

    dt = softplus(dt.to(f) + p["dt_bias"].to(f))
    A = -torch.exp(p["a_log"].to(f))                      # [nh], negative
    dA = dt * A[None, None, :]                            # [B,S,nh] log-decay

    xh = x.reshape(B_, S, nh, hd)
    # chunk views: the chunks are sequence-parallel over `model`
    # (intra-chunk work is independent across chunks)
    xc = hint(_chunks(xh, n, Qe), DP, "model", None, None, None)
    Bc = hint(_chunks(Bmat, n, Qe).to(f), DP, "model", None, None)
    Cc = hint(_chunks(Cmat, n, Qe).to(f), DP, "model", None, None)
    dtc = hint(_chunks(dt, n, Qe), DP, "model", None, None)
    dAc = hint(_chunks(dA, n, Qe), DP, "model", None, None)

    # the per-chunk work on each rank's own chunks (a plain tensor op
    # inside: DTensor's einsum views would merge the sharded batch and
    # chunk dims)
    chunked = (DP, "model", None, None)
    y_intra, chunk_state, seg_last, decay_in = autoshard.local_call(
        lambda *a: _chunk_terms(cd, *a), (xc, Bc, Cc, dtc, dAc),
        (chunked + (None,), chunked, chunked, chunked, chunked))

    # --- inter-chunk state passing: a triangular product over chunks ---
    # on each rank's rows, the chunks whole (DTensor has no rule for the
    # flip in a cumsum's backward)
    L = autoshard.local_call(lambda t: torch.cumsum(t, dim=1), (seg_last,),
                             ((DP, None, None),))         # [B,n,nh]
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    Wd = _masked_exp(tri[None, :, :, None],
                     L[:, :, None, :] - L[:, None, :, :])  # [B,n,m,nh]
    # the output chunk axis stays sharded: the contraction over the
    # sharded m axis then reduce-scatters its partial sums
    st_scan = hint(torch.einsum("bnmh,bmhds->bnhds", Wd, chunk_state),
                   DP, "model", None, None, None)
    # state entering chunk n = scan result of chunks < n
    h_in = torch.cat([torch.zeros_like(st_scan[:, :1]), st_scan[:, :-1]],
                     dim=1)                               # [B,n,nh,hd,ds]
    y_inter = autoshard.local_call(
        lambda C, h, d: torch.einsum("bnis,bnhds->bnihd", C, h) * d[..., None],
        (Cc, h_in, decay_in), (chunked, chunked + (None,), chunked))

    # the gradient of this view comes back laid out as y is (a sequence
    # sharded where the chunks were not cannot be viewed into them)
    y = autoshard.pin((y_intra + y_inter).reshape(B_, S, nh, hd))
    y = y + xh.to(f) * p["d_skip"].to(f)[None, None, :, None]
    y = autoshard.pin(y.reshape(B_, S, di)).to(cd)
    return _gated_norm_out(cfg, p, y, z)


def _chunk_terms(cd, xc, Bc, Cc, dtc, dAc):
    """The work within each chunk: (the intra-chunk output y [B,n,Q,nh,hd],
    each chunk's final state [B,n,nh,hd,ds], its total log-decay [B,n,nh],
    the decay from its start to each position [B,n,Q,nh])."""
    f = layers.acc_dtype(cd)
    Qe = xc.shape[2]
    seg = torch.cumsum(dAc, dim=2)                        # [B,n,Q,nh]
    # --- intra-chunk (quadratic within the chunk) ---
    # decay from position j to i (i >= j): exp(seg_i - seg_j)
    causal = torch.tril(torch.ones((Qe, Qe), dtype=torch.bool,
                                   device=xc.device))
    cb = torch.einsum("bnis,bnjs->bnij", Cc, Bc)          # [B,n,Q,Q]
    seg_h = seg.transpose(2, 3)                           # [B,n,nh,Q]
    rel = seg_h[..., :, None] - seg_h[..., None, :]       # [B,n,nh,Q,Q]
    gamma = _masked_exp(causal, rel)
    att = (cb[:, :, None] * gamma).to(cd)                 # [B,n,nh,Q,Q]
    # bnhij,bnhj,bnhjd->bnhid with float32 products and sums
    dx = (dtc.transpose(2, 3).to(cd).to(f)[..., None]
          * xc.permute(0, 1, 3, 2, 4).to(cd).to(f))       # [B,n,nh,Q,hd]
    y_intra = torch.matmul(att.to(f), dx)                 # [B,n,nh,Q,hd]
    y_intra = y_intra.permute(0, 1, 3, 2, 4)              # [B,n,Q,nh,hd]
    # each chunk's state from its own positions
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)     # [B,n,Q,nh]
    xw = xc.to(f) * (dtc * decay_to_end)[..., None]       # [B,n,Q,nh,hd]
    chunk_state = torch.einsum("bnjs,bnjhd->bnhds", Bc, xw)
    return y_intra, chunk_state, seg[:, :, -1, :], torch.exp(seg)


def final_state(cfg: ModelConfig, p: dict, xin: torch.Tensor) -> SSDState:
    """The SSD state after consuming xin [B, S, D] (the prefill -> decode
    handoff; the reference's ``transformer._ssd_final_state``): a
    whole-sequence cumsum, not chunked. ``h`` in float32; the conv tail in
    the compute dtype (the reference returns its values as float32, its
    cache declares the compute dtype: the values are the same)."""
    cd = layers.compute_dtype(cfg)
    f = layers.acc_dtype(cd)
    di, nh, ds, _ = _dims(cfg)
    B_, S, _ = xin.shape
    zxbcdt = layers._dot(xin.to(cd), p["in_proj"].to(cd), 1)
    _, x, Bmat, Cmat, dt = _split_proj(cfg, zxbcdt)
    xbc, tail = _causal_conv(cfg, p, torch.cat([x, Bmat, Cmat], dim=-1))
    x, Bmat, _ = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = softplus(dt.to(f) + p["dt_bias"].to(f))
    A = -torch.exp(p["a_log"].to(f))
    seg = torch.cumsum(dt * A[None, None, :], dim=1)
    decay_to_end = torch.exp(seg[:, -1:, :] - seg)        # [B,S,nh]
    xh = x.reshape(B_, S, nh, cfg.ssm.head_dim).to(f)
    h = torch.einsum("bts,bthd->bhds", Bmat.to(f),
                     xh * (dt * decay_to_end)[..., None])
    return SSDState(h=h, conv=tail)


def ssd_decode_step(cfg: ModelConfig, p: dict, xin: torch.Tensor,
                    state: SSDState) -> tuple[torch.Tensor, SSDState]:
    """One-token decode. xin: [B, 1, D] -> ([B, 1, D], new state)."""
    cd = layers.compute_dtype(cfg)
    f = layers.acc_dtype(cd)
    di, nh, ds, dc = _dims(cfg)
    hd = cfg.ssm.head_dim
    B_ = xin.shape[0]

    zxbcdt = layers._dot(xin.to(cd), p["in_proj"].to(cd), 1)
    z, x, Bmat, Cmat, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, Bmat, Cmat], dim=-1)              # [B,1,conv_dim]
    xbc_act, new_tail = _causal_conv(cfg, p, xbc, conv_tail=state.conv)
    x, Bmat, Cmat = torch.split(xbc_act, [di, ds, ds], dim=-1)

    dt = softplus(dt[:, 0].to(f) + p["dt_bias"].to(f))   # [B,nh]
    A = -torch.exp(p["a_log"].to(f))
    da = torch.exp(dt * A[None, :])                       # [B,nh]

    xh = x[:, 0].reshape(B_, nh, hd).to(f)
    Bv = Bmat[:, 0].to(f)                                 # [B,ds]
    Cv = Cmat[:, 0].to(f)
    h = (state.h * da[:, :, None, None]
         + (xh * dt[:, :, None])[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhds,bs->bhd", h, Cv)
    y = y + xh * p["d_skip"].to(f)[None, :, None]
    y = y.reshape(B_, 1, di).to(cd)
    out = _gated_norm_out(cfg, p, y, z)
    return out, SSDState(h=h, conv=new_tail.to(state.conv.dtype))
