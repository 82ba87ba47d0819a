"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427], the
twin of the reference's ``models/rglru.py``.

The recurrence  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)  is a
diagonal linear recurrence: full sequences run as an associative scan
(:func:`scan`), decode carries a [B, lru_width] state. The gates are
block-diagonal linear maps (RecurrentGemma's ``block_width`` heads).

Block layout (Griffin "recurrent block"): the residual branch splits into a
GeLU gate branch and a conv1d(4) -> RG-LRU branch, merged multiplicatively
and projected back to d_model.

Numerics follow the reference: the projections and the conv in
``cfg.compute_dtype``, the gates, the scan and the state in float32
(``layers.acc_dtype``: float64 at a float64 compute dtype). The gates read
their weights (``FLOAT_LEAVES``) in that float dtype, so serving keeps
them unrounded (``transformer.compute_params``).

Where the port departs from a straight translation:
* ``jax.lax.associative_scan`` is a Python odd/even recursion of
  element-wise ops; :func:`scan` is the same recursion, so each element
  takes the reference's rounding order. XLA's CPU compiler contracts a
  product feeding an add into a fused multiply-add (the combine's
  ``b1 * a2 + b2``, decode's ``a * h + gx``, the gate's ``1 - a * a``);
  the port writes those three as ``torch.addcmul``, which is one on the
  CPU, so the scan of the same inputs gives the reference's bits. The
  conv keeps the written order (XLA contracts its sum of products too,
  but at bfloat16 it rounds each op, and the float32 difference is a
  last bit);
* ``jax.nn.softplus`` is ``logaddexp(x, 0)`` (``ssm.softplus``), not
  ``F.softplus`` with its threshold;
* ``jax.nn.gelu`` is the tanh form op by op in the input dtype
  (``layers.gelu_tanh``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import autoshard
from repro_torch.models import layers
from repro_torch.models.params import PSpec
from repro_torch.models.ssm import softplus

_C_SCALE = 8.0  # Griffin's fixed recurrence sharpness c

# The leaves the gates read in float32 (``_gates`` casts them to the float32
# recurrent input's dtype): serving keeps them in their own dtype.
FLOAT_LEAVES = ("w_a", "b_a", "w_x", "b_x", "lambda_p")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model         # lru_width (recurrentgemma: == d_model)
    nb = cfg.n_heads                    # gate block count
    return di, nb, di // nb, s.d_conv


def rglru_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, nb, bw, dc = _dims(cfg)
    return {
        "w_gate_branch": PSpec((d, di), ("embed", "inner")),
        "w_rec_branch": PSpec((d, di), ("embed", "inner")),
        "conv_w": PSpec((dc, di), ("conv", "inner"), "scaled", 0.1),
        "conv_b": PSpec((di,), ("inner",), "zeros"),
        # block-diagonal input/recurrence gates
        "w_a": PSpec((nb, bw, bw), ("ssm_heads", None, None)),
        "b_a": PSpec((di,), ("inner",), "zeros"),
        "w_x": PSpec((nb, bw, bw), ("ssm_heads", None, None)),
        "b_x": PSpec((di,), ("inner",), "zeros"),
        # softplus-parameterised Lambda, init so a^c ~ U[0.9, 0.999]-ish
        "lambda_p": PSpec((di,), ("inner",), "ones"),
        "w_out": PSpec((di, d), ("inner", "embed")),
    }


class RGLRUState(NamedTuple):
    """Decode-time state for one RG-LRU layer."""

    h: torch.Tensor     # [B, di] recurrent state (float32)
    conv: torch.Tensor  # [B, d_conv-1, di] conv tail


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device=None) -> RGLRUState:
    di, _, _, dc = _dims(cfg)
    return RGLRUState(
        h=torch.zeros((batch, di), dtype=dtype, device=device),
        conv=torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
    )


def _block_linear(w: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: x [..., di] with w [nb, bw, bw]."""
    nb, bw, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (nb, bw))
    out = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return out.reshape(x.shape) + b.to(x.dtype)


def _gates(cfg: ModelConfig, p: dict, xr: torch.Tensor):
    """Recurrence gate a_t and the gated input. xr: [..., di] float32."""
    r = torch.sigmoid(_block_linear(p["w_a"], p["b_a"], xr))
    i = torch.sigmoid(_block_linear(p["w_x"], p["b_x"], xr))
    # a = sigmoid(lambda)^(c*r)  -> log a = -c * r * softplus(lambda_p)
    log_a = (-_C_SCALE * r) * softplus(p["lambda_p"].to(xr.dtype))
    a = torch.exp(log_a)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    # 1 - a * a as one fused multiply-add, as XLA contracts it
    gated_x = (torch.sqrt(torch.clamp_min(
        torch.addcmul(one, a, a, value=-1.0), 1e-12)) * (i * xr))
    return a, gated_x


def _causal_conv(cfg: ModelConfig, p: dict, x: torch.Tensor, tail=None):
    """Depthwise causal conv over the sequence. x: [B, S, di]. Returns
    (conv + bias, the last d_conv - 1 inputs: for S < d_conv - 1 they
    include the zero pad or the old tail)."""
    dc = cfg.ssm.d_conv
    if tail is None:
        pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    # the reference's order: a Python sum from 0 over the shifted products
    out = sum(xp[:, i:i + S, :] * p["conv_w"][i].to(x.dtype)
              for i in range(dc)) + p["conv_b"].to(x.dtype)
    return out, xp[:, xp.shape[1] - (dc - 1):, :]


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): (a1 a2, b1 a2 + b2), the second as one fused
    multiply-add, as XLA contracts it."""
    return a1 * a2, torch.addcmul(b2, b1, a2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 1 (``even`` may be one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] == n:
        return pairs
    return torch.cat([pairs, even[:, n:]], dim=1)


def scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The inclusive scan of h_t = a_t h_{t-1} + b_t over dim 1 (h_{-1} =
    0): returns (the products of a, h). ``jax.lax.associative_scan``'s
    recursion: combine adjacent pairs, scan the half-length sequence (the
    odd positions), combine each odd result with the next even element,
    interleave; about 2 log2(S) levels of strided element-wise ops."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


_LOCAL = ("conv_w", "conv_b", "w_a", "b_a", "w_x", "b_x", "lambda_p")


def _local(core, ins: tuple, p: dict, out_of=0):
    """``core(*ins, *p's conv and gate leaves)`` on each rank's own rows
    (over the data axes) and channels (over ``model`` where both the width
    and the gate blocks divide it), the sequence whole: the conv, the
    gates and the scan are element-wise or block-local in the channels
    and sequential in the sequence (:func:`autoshard.local_call`). The
    outputs are laid out as ``ins[out_of]`` (one input an output when a
    tuple). The identity wrapper without a mesh."""
    di, nb = p["b_a"].shape[0], p["w_a"].shape[0]
    m = autoshard.group_size(("model",))
    ch = "model" if di % m == 0 and nb % m == 0 else None
    n = autoshard.group_size(autoshard.DP)
    split = n > 1 and ins[0].shape[0] % n == 0
    row = (autoshard.DP,) + (None,) * (ins[0].dim() - 2) + (ch,)
    axes = tuple(row[:1] + (None,) * (a.dim() - 2) + (ch,) for a in ins)
    axes += ((None, ch), (ch,), (ch, None, None), (ch,), (ch, None, None),
             (ch,), (ch,))
    first = len(ins)
    grads = {first + i: autoshard.DP for i in range(len(_LOCAL))} \
        if split else {}
    return autoshard.local_call(
        lambda *a: core(*a[:first], dict(zip(_LOCAL, a[first:]))),
        ins + tuple(p[k] for k in _LOCAL), axes, out_of=out_of,
        partial_grads=grads)


def _recurrence(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The rec branch over a full sequence (x [B, S, D] in the compute
    dtype): (h [B, S, di] float32, the conv tail)."""
    rec = layers._dot(x, p["w_rec_branch"].to(x.dtype), 1)

    def core(rec, q):
        rec, tail = _causal_conv(cfg, q, rec)
        a, gx = _gates(cfg, q, rec.to(layers.acc_dtype(x.dtype)))
        # h_t = a_t h_{t-1} + gx_t  — associative over the sequence axis.
        _, h = scan(a, gx)
        return h, tail

    return _local(core, (rec,), p)


def _block(cfg: ModelConfig, p: dict, xin: torch.Tensor):
    """(out [B, S, D], h [B, S, di], the conv tail)."""
    cd = layers.compute_dtype(cfg)
    x = xin.to(cd)
    gate = layers.gelu_tanh(layers._dot(x, p["w_gate_branch"].to(cd), 1))
    h, tail = _recurrence(cfg, p, x)
    return layers._dot(h.to(cd) * gate, p["w_out"].to(cd), 1), h, tail


def rglru_forward(cfg: ModelConfig, p: dict,
                  xin: torch.Tensor) -> torch.Tensor:
    """Full-sequence recurrent block. xin: [B, S, D] -> [B, S, D]."""
    return _block(cfg, p, xin)[0]


def rglru_prefill(cfg: ModelConfig, p: dict, xin: torch.Tensor
                  ) -> tuple[torch.Tensor, RGLRUState]:
    """:func:`rglru_forward` and the state after consuming xin, from one
    pass (the reference recomputes the rec branch and the scan for the
    state, :func:`final_state`; the same ops give the same values)."""
    out, h, tail = _block(cfg, p, xin)
    return out, RGLRUState(h=h[:, -1], conv=tail)


def final_state(cfg: ModelConfig, p: dict, xin: torch.Tensor) -> RGLRUState:
    """The state (h float32, the conv tail in the compute dtype) after
    consuming xin [B, S, D]: the prefill -> decode handoff, the reference's
    ``transformer._rglru_final_state``."""
    h, tail = _recurrence(cfg, p, xin.to(layers.compute_dtype(cfg)))
    return RGLRUState(h=h[:, -1], conv=tail)


def rglru_decode_step(cfg: ModelConfig, p: dict, xin: torch.Tensor,
                      state: RGLRUState) -> tuple[torch.Tensor, RGLRUState]:
    """One-token decode. xin: [B, 1, D] -> ([B, 1, D], new state)."""
    cd = layers.compute_dtype(cfg)
    x = xin.to(cd)
    gate = layers.gelu_tanh(layers._dot(x, p["w_gate_branch"].to(cd), 1))
    rec = layers._dot(x, p["w_rec_branch"].to(cd), 1)

    def core(rec, tail, h, q):
        rec, new_tail = _causal_conv(cfg, q, rec, tail=tail)
        a, gx = _gates(cfg, q, rec[:, 0].to(layers.acc_dtype(cd)))
        return torch.addcmul(gx, a, h), new_tail           # [B, di]

    h, new_tail = _local(core, (rec, state.conv, state.h), p, out_of=(2, 1))
    out = layers._dot(h[:, None, :].to(cd) * gate, p["w_out"].to(cd), 1)
    return out, RGLRUState(h=h, conv=new_tail.to(state.conv.dtype))
