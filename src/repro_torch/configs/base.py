"""Model configuration schema for the assigned architectures (a copy of the
reference's ``configs/base.py``; it is plain data and imports no JAX).

One frozen dataclass covers dense / MoE / SSM / hybrid / vlm / audio families;
`layer_pattern` describes the repeating per-layer kinds so heterogeneous
stacks (gemma3 5:1 local:global, recurrentgemma 2:1 RG-LRU:attn, llama-vision
cross-attn insertions) stack one repetition of the pattern (a super-block)
along a leading layer dim; the port loops over it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Layer kinds.
GLOBAL = "global"        # full causal self-attention
LOCAL = "local"          # sliding-window causal self-attention
CROSS = "cross"          # self-attention + gated cross-attention (vlm)
RGLRU = "rglru"          # Griffin RG-LRU recurrent block
SSD = "ssd"              # Mamba-2 state-space dual block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256               # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None    # default d_model // n_heads
    layer_pattern: Sequence[str] = (GLOBAL,)  # tiled to n_layers (+ remainder)
    sliding_window: int = 4096
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # vlm: number of (stub) image tokens attended by cross-attn layers.
    n_cross_tokens: int = 0
    # audio/vlm stub: inputs arrive as precomputed frame/patch embeddings.
    embeds_input: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # streaming-softmax key-chunk size for full-sequence attention (flash
    # attention at the HLO level; S <= attn_chunk uses the dense-mask path)
    attn_chunk: int = 512
    # long_500k eligibility (brief: skip pure full-attention archs). Set
    # explicitly per config; see DESIGN.md §4 for the skip table.
    long_context_ok: bool = False
    # memory
    remat: str = "none"             # none | full | dots
    # optimizer-state dtype (arctic needs bf16 moments to fit v5e HBM)
    adam_dtype: str = "float32"
    # gradient-accumulation microbatches for the train_4k cell
    train_microbatches: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind list of length n_layers (pattern tiled + truncated)."""
        p = tuple(self.layer_pattern)
        reps = -(-self.n_layers // len(p))
        return (p * reps)[: self.n_layers]

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic stacks: SSM / hybrid / local-dominant patterns."""
        return self.long_context_ok

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        dh = self.head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # head
        for kind in self.layer_kinds:
            if kind in (GLOBAL, LOCAL, CROSS):
                # CROSS layers carry one (gated cross-) attention sub-block,
                # same parameter count as self-attention.
                qkv = d * dh * (self.n_heads + 2 * self.n_kv_heads)
                o = self.n_heads * dh * d
                total += qkv + o
                total += self._ffn_params()
                total += 2 * d  # norms
            elif kind == RGLRU:
                assert self.ssm is not None
                di = self.ssm.expand * d
                total += 2 * d * di + di * d        # gate/in proj + out proj
                total += di * self.ssm.d_conv        # conv
                total += 3 * di                       # lambda + gates biases
                total += self._ffn_params() + 2 * d
            elif kind == SSD:
                assert self.ssm is not None
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                total += d * (2 * di + 2 * self.ssm.d_state + nh)  # in_proj
                total += di * d                       # out_proj
                total += (di + 2 * self.ssm.d_state) * self.ssm.d_conv
                total += 2 * nh + di                  # A, dt bias, norm
                total += d                            # norm
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        e = self.moe
        per_expert = self._expert_params()
        inactive = (e.n_experts - e.top_k) * per_expert * self._n_moe_layers()
        return total - inactive

    def _n_moe_layers(self) -> int:
        return sum(1 for k in self.layer_kinds if k in (GLOBAL, LOCAL, CROSS)) \
            if self.moe else 0

    def _expert_params(self) -> int:
        assert self.moe is not None
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.moe.d_ff_expert

    def _ffn_params(self) -> int:
        if self.moe is not None:
            p = self.moe.n_experts * self._expert_params()
            p += self.d_model * self.moe.n_experts  # router
            if self.moe.dense_residual:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                p += mult * self.d_model * self.d_ff
            return p
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell's input shape (from the assignment brief)."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
