"""Plain PyTorch reference of the Tsetlin Machine the benchmark drives.

It recomputes, from the benchmark's own inputs, what the system under
test produces: the TA banks after online learning, the accuracy analysis
and the rollback policy, and the served predictions. It imports nothing
of the system under test and runs on any torch device, one machine per row of a
``[S, ...]`` batch (S sampled replicas), each with its own key.

The random numbers follow the counter-based threefry2x32 generator in
its partitionable form (element ``i`` of a draw is the block function of
its flat index), as the system's published semantics fix them, so a
bank recomputed here is bit for bit the bank the system must hold.
Words are int64 tensors masked to 32 bits.

``uniform_dtype`` is the precision of the uniform draws: float32 is the
configuration's; ``torch.bfloat16`` rounds every uniform to bfloat16
first, the lower-precision control that the correctness check must
reject.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000


# ---------------------------------------------------------------------------
# threefry2x32 (a frozen copy of the block function) and the draws on it
# ---------------------------------------------------------------------------


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block function on int64-held words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key_from_seed(seed: int, device=None) -> torch.Tensor:
    """A key [2] from a seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def _block(keys: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """The block function of keys [..., 2] on counters broadcast against
    a trailing counter axis."""
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """keys [..., 2] -> [..., num, 2]: row i is the block of counter i."""
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    b0, b1 = _block(keys, i >> 32, i & M32)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """keys [..., 2] and an int, or a 1-D array of n ints (then
    [..., n, 2]): the block of counter (0, data)."""
    if isinstance(data, (int, np.integer)):
        d = torch.tensor([int(data) & M32], dtype=torch.int64,
                         device=keys.device)
        b0, b1 = _block(keys, torch.zeros_like(d), d)
        return torch.cat([b0, b1], dim=-1)
    d = torch.as_tensor(np.asarray(data, dtype=np.int64) & M32,
                        device=keys.device)
    b0, b1 = _block(keys, torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def uniform(keys: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """float32 uniforms in [0, 1) of shape [..., *shape] for keys [..., 2]:
    the XOR of the two words, its top 23 bits as a mantissa in [1, 2),
    minus 1. With ``dtype`` bfloat16 each is rounded to bfloat16."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = _block(keys, i >> 32, i & M32)
    bits = ((b0 ^ b1) >> 9) | _ONE_BITS
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    f = torch.clamp(f, min=0.0)
    if dtype != torch.float32:
        f = f.to(dtype).to(torch.float32)
    return f.reshape(keys.shape[:-1] + shape)


# ---------------------------------------------------------------------------
# The machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Machine:
    """The configuration's sizes and feedback rule.

    ``boost`` is "boost true positive feedback" (strengthen with
    probability 1); ``s_policy`` "standard" erases with probability 1/s.
    """

    n_features: int
    n_classes: int
    n_clauses: int
    n_states: int
    boost: bool = True
    s_policy: str = "standard"

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.n_classes, self.n_clauses, self.n_literals)


def literals(x: torch.Tensor) -> torch.Tensor:
    """Feature rows [..., f] bool -> literals [..., 2f]: [x, not x]."""
    x = x.to(torch.bool)
    return torch.cat([x, ~x], dim=-1)


def polarity(m: Machine, device) -> torch.Tensor:
    """+1 for even clauses, -1 for odd: [J] int32."""
    j = torch.arange(m.n_clauses, device=device)
    return 1 - 2 * (j % 2).to(torch.int32)


def clause_outputs(m: Machine, bank: torch.Tensor, lits: torch.Tensor, *,
                   training: bool) -> torch.Tensor:
    """bank [S, C, J, L], lits [S, B, L] -> clause outputs [S, B, C, J]:
    a clause fires where no included literal is 0; a clause with nothing
    included outputs 1 in training and 0 in inference."""
    include = (bank > m.n_states).to(torch.float32)             # [S, C, J, L]
    S, C, J, L = include.shape
    zeros = (~lits).to(torch.float32)                           # [S, B, L]
    viol = torch.bmm(zeros, include.reshape(S, C * J, L).transpose(1, 2))
    n_inc = include.sum(-1).reshape(S, 1, C * J)
    fired = viol == 0
    if not training:
        fired = fired & (n_inc > 0)
    return fired.reshape(S, -1, C, J)


def class_sums(m: Machine, clauses: torch.Tensor) -> torch.Tensor:
    """Votes [..., C] int32 from clause outputs [..., C, J]."""
    return (clauses.to(torch.int32) * polarity(m, clauses.device)).sum(
        -1, dtype=torch.int32)


def first_argmax(v: torch.Tensor) -> torch.Tensor:
    """The first index of the maximum over the last axis (int64)."""
    idx = torch.arange(v.shape[-1], device=v.device)
    top = v.max(-1, keepdim=True).values
    return torch.where(v == top, idx, v.shape[-1]).min(-1).values


def predict(m: Machine, bank: torch.Tensor, xs: torch.Tensor,
            block: int = 256) -> torch.Tensor:
    """Predicted classes [S, B] of machines bank [S, ...] on rows xs
    [B, f] (shared by all) or [S, B, f], in blocks of ``block`` rows."""
    S = bank.shape[0]
    if xs.dim() == 2:
        xs = xs.expand((S,) + tuple(xs.shape))
    out = []
    for i in range(0, xs.shape[1], block):
        lits = literals(xs[:, i:i + block])
        votes = class_sums(m, clause_outputs(m, bank, lits, training=False))
        out.append(first_argmax(votes))
    return torch.cat(out, dim=1)


def accuracy(m: Machine, bank: torch.Tensor, xs: torch.Tensor,
             ys: torch.Tensor) -> np.ndarray:
    """Accuracy [S] float32 on a set: the count of correct rows times
    float32(1 / n), as the system defines the analysis block's mean."""
    hits = (predict(m, bank, xs) == ys.to(torch.int64)).sum(-1)
    n = xs.shape[-2]
    inv = np.float32(1) / np.float32(n)
    return hits.cpu().numpy().astype(np.float32) * inv


def feedback_update(m: Machine, bank: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor, keys: torch.Tensor, s: torch.Tensor,
                    T: torch.Tensor, valid: torch.Tensor,
                    uniform_dtype=torch.float32) -> torch.Tensor:
    """One labelled datapoint for every machine of the batch.

    bank [S, C, J, L] int32, x [S, f], y [S], keys [S, 2] (the step's
    key), s [S] float32, T [S] int32, valid [S] bool (rows not valid keep
    their bank). Returns the new bank.

    The step key splits into a selection key and a bank key; the
    selection key splits three ways: the non-target class (the first
    largest uniform over the other classes), the target's clauses, and
    the non-target's clauses. Target y gives feedback with probability
    (T - clip(v_y)) / 2T, positive clauses Type I and negative Type II;
    the non-target with (T + clip(v_ny)) / 2T, positive Type II and
    negative Type I. Type I: a firing clause on a 1-literal strengthens
    with probability p_s, else the automaton moves toward exclude with
    probability p_e. Type II: a firing clause on a 0-literal includes an
    excluded automaton. States stay in [1, 2N].
    """
    S = bank.shape[0]
    C, J, L = m.shape
    dev = bank.device
    k2 = split(keys, 2)
    k_sel, k_u = k2[:, 0], k2[:, 1]
    ks = split(k_sel, 3)
    k_neg, k_t, k_n = ks[:, 0], ks[:, 1], ks[:, 2]

    lits = literals(x)                                          # [S, L]
    clauses = clause_outputs(m, bank, lits[:, None], training=True)[:, 0]
    votes = class_sums(m, clauses)                              # [S, C]

    cls = torch.arange(C, device=dev)
    y = y.to(torch.int64)
    u_neg = uniform(k_neg, (C,), uniform_dtype)                 # [S, C]
    ny = first_argmax(torch.where(cls[None] != y[:, None], u_neg, -1.0))
    Tf = T.to(torch.float32)
    v = torch.minimum(torch.maximum(votes, -T[:, None]), T[:, None]).to(
        torch.float32)
    rows = torch.arange(S, device=dev)
    p_t = (Tf - v[rows, y]) / (2.0 * Tf)
    p_n = (Tf + v[rows, ny]) / (2.0 * Tf)
    sel_t = uniform(k_t, (J,), uniform_dtype) < p_t[:, None]    # [S, J]
    sel_n = uniform(k_n, (J,), uniform_dtype) < p_n[:, None]

    pos = polarity(m, dev) > 0                                  # [J]
    is_y = (cls[None] == y[:, None])[:, :, None]                # [S, C, 1]
    is_n = (cls[None] == ny[:, None])[:, :, None]
    t1 = (is_y & (sel_t & pos)[:, None]) | (is_n & (sel_n & ~pos)[:, None])
    t2 = (is_y & (sel_t & ~pos)[:, None]) | (is_n & (sel_n & pos)[:, None])

    u = uniform(k_u, (C, J, L), uniform_dtype)                  # [S, C, J, L]
    one = torch.ones((), dtype=torch.float32, device=dev)
    p_s = one if m.boost else (s - 1.0) / s
    p_e = (one / s) if m.s_policy == "standard" else (s - 1.0) / s
    if torch.is_tensor(p_s) and p_s.dim():
        p_s = p_s[:, None, None, None]
    p_e = p_e[:, None, None, None] if p_e.dim() else p_e
    lit = lits[:, None, None, :]
    fire = clauses[..., None]
    include = bank > m.n_states
    d1 = torch.where(fire & lit, (u < p_s).to(torch.int32),
                     -(u < p_e).to(torch.int32))
    d2 = (fire & ~lit & ~include).to(torch.int32)
    delta = (torch.where(t1[..., None], d1, 0)
             + torch.where(t2[..., None], d2, 0))
    new = torch.clamp(bank + delta, 1, 2 * m.n_states)
    return torch.where(valid[:, None, None, None], new, bank)
