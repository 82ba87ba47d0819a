"""Clause-plane counts: the hand-written CUDA kernels K1 and K2.

Replaces the Pallas kernels ``clause_counts`` (K1) and
``clause_counts_batch`` (K2) of the reference package's
``kernels/clause_eval.py``, which cast the counts as an int8 MXU matmul
with a ones column. Here (``csrc/clause_eval.cu``) they are plain integer
counts over 1-byte bools:

    violations[cj, b] = sum_l include[cj, l] & ~literal[b, l]
    n_included[cj]    = sum_l include[cj, l]

Bound on an H100: memory. K1 reads the [CJ, L] include plane once per
datapoint (1.0 MB at the MNIST width) and does one add per byte; K2 reads
it once per batch plus B x L literal bytes and writes CJ x B int32 counts.
K1 gives each clause row a warp whose lanes stride over L; K2 packs both
planes 32 bools to a word once, then counts AND-NOT popcounts over word
tiles staged in shared memory. See the source for the layout.

Each wrapper takes its plain PyTorch version (``*_plain``) for CPU
tensors. For CUDA tensors it launches the kernel, counts the launch in
``<wrapper>.launches``, or raises; it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Shared memory one block may use on Hopper (bytes): it bounds the literal
# width the batch kernel's word tiles take (L up to ~19 k).
MAX_SMEM = 227 * 1024


def clause_counts_plain(include: torch.Tensor, literals: torch.Tensor):
    """K1's plain version: (violations [CJ] i32, n_included [CJ] i32)."""
    inc = include.to(torch.bool)
    viol = (inc & ~literals.to(torch.bool)[None, :]).sum(-1)
    return viol.to(torch.int32), inc.sum(-1).to(torch.int32)


def clause_counts_batch_plain(include: torch.Tensor, literals: torch.Tensor):
    """K2's plain version: (violations [CJ, B] i32, n_included [CJ] i32).

    One float32 product of 0/1 operands: exact, since counts <= L < 2**24.
    """
    inc = include.to(torch.float32)
    neg = 1.0 - literals.to(torch.float32)
    viol = inc @ neg.T
    return viol.to(torch.int32), include.to(torch.bool).sum(-1).to(torch.int32)


def _bytes(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype not in (torch.bool, torch.uint8, torch.int8):
        raise TypeError(f"{name} must be bool/uint8/int8, got {t.dtype}")
    return t.contiguous().view(torch.uint8)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def clause_counts(include: torch.Tensor, literals: torch.Tensor):
    """K1: include [CJ, L] x literals [L] -> (violations, n_included), both
    [CJ] i32."""
    cj, L = include.shape
    if literals.shape != (L,):
        raise ValueError(f"literals {tuple(literals.shape)} != ({L},)")
    if include.device.type == "cpu":
        return clause_counts_plain(include, literals)
    if include.device != literals.device:
        raise ValueError("include and literals on different devices")
    inc, lit = _bytes(include, "include"), _bytes(literals, "literals")
    viol = torch.empty(cj, dtype=torch.int32, device=include.device)
    ninc = torch.empty(cj, dtype=torch.int32, device=include.device)
    lib = _build.library("clause_eval")
    _build.check(lib.clause_counts(
        inc.data_ptr(), lit.data_ptr(), viol.data_ptr(), ninc.data_ptr(),
        cj, L, _stream(inc)), "clause_counts")
    clause_counts.launches += 1
    return viol, ninc


clause_counts.launches = 0


def clause_counts_batch(include: torch.Tensor, literals: torch.Tensor):
    """K2: include [CJ, L] x literals [B, L] -> (violations [CJ, B] i32,
    n_included [CJ] i32)."""
    cj, L = include.shape
    B = literals.shape[0]
    if B < 1 or literals.shape != (B, L):
        raise ValueError(f"literals {tuple(literals.shape)} != (B>=1, {L})")
    if include.device.type == "cpu":
        return clause_counts_batch_plain(include, literals)
    if include.device != literals.device:
        raise ValueError("include and literals on different devices")
    lib = _build.library("clause_eval")
    if lib.clause_counts_batch_smem(L) > MAX_SMEM:
        raise ValueError(f"literal width {L} exceeds the batch kernel's "
                         "shared-memory tile")
    inc, lit = _bytes(include, "include"), _bytes(literals, "literals")
    dev = include.device
    viol = torch.empty((cj, B), dtype=torch.int32, device=dev)
    ninc = torch.empty(cj, dtype=torch.int32, device=dev)
    words = torch.empty((cj + B) * (-(-L // 32)), dtype=torch.int32,
                        device=dev)   # the packed planes (kernel scratch)
    _build.check(lib.clause_counts_batch(
        inc.data_ptr(), lit.data_ptr(), viol.data_ptr(), ninc.data_ptr(),
        words.data_ptr(), cj, L, B, _stream(inc)), "clause_counts_batch")
    clause_counts_batch.launches += 1
    return viol, ninc


clause_counts_batch.launches = 0


def clause_eval(include: torch.Tensor, literals: torch.Tensor, *,
                training: bool) -> torch.Tensor:
    """Kernel-backed clause outputs [C, J] bool (the ref contract)."""
    C, J, L = include.shape
    viol, n_inc = clause_counts(include.reshape(C * J, L), literals)
    fired = viol == 0
    empty = n_inc == 0
    return torch.where(empty, training, fired).reshape(C, J)


def clause_eval_batch(include: torch.Tensor, literals: torch.Tensor, *,
                      training: bool) -> torch.Tensor:
    """Kernel-backed batch-first clause outputs [B, C, J] bool."""
    C, J, L = include.shape
    B = literals.shape[0]
    viol, n_inc = clause_counts_batch(include.reshape(C * J, L), literals)
    fired = (viol == 0).T.reshape(B, C, J)
    empty = (n_inc == 0).reshape(C, J)
    return torch.where(empty[None], training, fired)
