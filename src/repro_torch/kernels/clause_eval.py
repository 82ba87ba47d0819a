"""Clause-plane counts: the hand-written CUDA kernels K1 to K7.

Replaces the Pallas kernels ``clause_counts`` (K1), ``clause_counts_batch``
(K2), ``clause_counts_replicated`` (K3),
``clause_counts_batch_replicated`` (K4), ``clause_counts_batch_packed``
(K5) and ``clause_counts_batch_replicated_packed`` (K6) of the reference
package's ``kernels/clause_eval.py``. K1-K4 there are int8 MXU matmuls
with a ones column; here (``csrc/clause_eval.cu``) K1/K3 are plain
integer counts and K2/K4 an int8 tensor-core product, over 1-byte bools
(any nonzero byte counts as 1):

    violations[r, cj, b] = sum_l include[r, cj, l] & ~literal[r % D, b, l]
    n_included[r, cj]    = sum_l include[r, cj, l]

K1 and K2 are one bank (R = D = 1); K3 and K4 take R banks and D data
streams (D | R), replica r reading stream r % D.

Bound on an H100: memory. K1/K3 read each [CJ, L] include plane once per
datapoint (1.0 MB a bank at the MNIST width, 8.0 MB at R = 8: about
2.4 us) and do one add per byte; K2/K4 read them once per batch plus the
D x B x L literal bytes and write R x CJ x B int32 counts (about 13 MB,
3.9 us, at R = D = 8 and B = 150). K1/K3 give each clause row a group of
lanes that load 16 include and 16 literal bytes at a time and count four
literals a popcount (where L % 16 == 0 and both operands are 16-byte
aligned; otherwise a warp per row strides over L a byte at a time). K2/K4
are one launch each, with no scratch: blocks of 64 clause rows x 64
batch columns (128 x 128 on grids of 8 or more such blocks an SM) stage
both operands through a four-deep ring of 64-byte chunks in shared
memory (16-byte ``cp.async`` copies on the same aligned widths, byte
loads otherwise), normalise the bytes in registers and count the
violations with ``mma.sync`` m16n8k32 u8 products (the include bytes
against the zero-literal bytes); n_included comes from the same staged
include tiles. Each tile re-reads its rows from L2, and that traffic
sets their time. See the source for the layout.

K5 and K6 take the bit-packed planes (int32 or uint32 words holding the
uint32 bits, :mod:`repro_torch.kernels.packing`): include [R, CJ, W] and
literals [D, B, W], W = 2 * ceil(f / 32), and give violations [R, CJ, B]
= sum_w popcount(include & ~literal), with no n_included (the callers
take emptiness from the include words). They run K2/K4's body on words,
one launch a call: the same tiles, ring and fragment addressing, with
``mma.sync`` m16n8k256 .b1 AND-popcount products of the include words
against the complemented literal words, staged by 16-, 8- or 4-byte
``cp.async`` copies (the widest the width and pointers allow; 8 for
every packed layout, W being even). No width cap: the ring's shared
memory does not grow with W. Bound on an H100: memory. The b1 product
counts about 21,700 bit operations a clock an SM, 44x ``__popc``
(``chip_smoke.py``'s b1_probe phase), so at 640 x 1024 x 50 its 1.05 G
bit operations take 0.2 us against 0.9 us for the 2.9 MB of operands and
int32 counts.

K7 is the four pruned entries: the include bank [R, C, J, L | W] with a
selection sel [R, C, M] of clause ids per class, counted as if the bank
were compacted to [R, C, M, L | W] (the reference's ``gather_include``
before a K2/K4/K5/K6 launch). Here the gather folds into the row loads,
so the work shrinks with the budget M / J: on bytes and on words the
body reads ``sel`` (int32 or int64; other integer types are cast once)
itself and stages bank row (r*C + c)*J + sel[r, c, m] for compacted row
(r, c, m), one launch a call. Bound on an H100: the elected rows, the
ids, the literals and the int32 violations over 3.35 TB/s (21-84 MB of
violations at R = 16, B = 1024, M = 32-128 dominate).

Each wrapper takes its plain PyTorch version (``*_plain``) for CPU
tensors. For CUDA tensors it launches the kernel, counts the launch in
``<wrapper>.launches``, or raises; it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_sel, gather_include

# The byte path's tensor-core sums hold 128 x the violations in int32.
MAX_BYTE_WIDTH = 2 ** 24 - 1
# The word path's sums reach 32 x W in int32.
MAX_WORD_WIDTH = 2 ** 26 - 1
# The grid's replica axis (gridDim.z / gridDim.y) holds at most this many.
MAX_REPLICAS = 65535


def _streams(R: int, D: int) -> int:
    if D < 1 or R % D:
        raise ValueError(f"data replicas {D} must divide replicas {R}")
    if R > MAX_REPLICAS:
        raise ValueError(f"{R} replicas exceed the kernels' grid axis "
                         f"({MAX_REPLICAS})")
    return R // D


def clause_counts_plain(include: torch.Tensor, literals: torch.Tensor):
    """K1's plain version: (violations [CJ] i32, n_included [CJ] i32)."""
    inc = include.to(torch.bool)
    viol = (inc & ~literals.to(torch.bool)[None, :]).sum(-1)
    return viol.to(torch.int32), inc.sum(-1).to(torch.int32)


def clause_counts_batch_plain(include: torch.Tensor, literals: torch.Tensor):
    """K2's plain version: (violations [CJ, B] i32, n_included [CJ] i32).

    One float32 product of 0/1 operands (any nonzero byte is 1): exact,
    since counts <= L < 2**24.
    """
    inc = include.to(torch.bool).to(torch.float32)
    neg = (~literals.to(torch.bool)).to(torch.float32)
    viol = inc @ neg.T
    return viol.to(torch.int32), include.to(torch.bool).sum(-1).to(torch.int32)


def clause_counts_replicated_plain(include: torch.Tensor,
                                   literals: torch.Tensor):
    """K3's plain version: (violations [R, CJ] i32, n_included [R, CJ] i32),
    replica r against literal row r % D."""
    R, cj, L = include.shape
    D = literals.shape[0]
    inc = include.to(torch.bool).reshape(R // D, D, cj, L)
    viol = (inc & ~literals.to(torch.bool)[None, :, None, :]).sum(-1)
    return (viol.reshape(R, cj).to(torch.int32),
            inc.sum(-1).reshape(R, cj).to(torch.int32))


def clause_counts_batch_replicated_plain(include: torch.Tensor,
                                         literals: torch.Tensor):
    """K4's plain version: (violations [R, CJ, B] i32, n_included [R, CJ]
    i32), replica r against batch r % D. One float32 batched product of
    0/1 operands (any nonzero byte is 1): exact, since counts <= L <
    2**24."""
    R, cj, L = include.shape
    D, B, _ = literals.shape
    inc = include.to(torch.bool).to(torch.float32).reshape(R // D, D, cj, L)
    neg = (~literals.to(torch.bool)).to(torch.float32)        # [D, B, L]
    viol = inc @ neg.transpose(-1, -2)[None]                  # [H, D, CJ, B]
    return (viol.reshape(R, cj, B).to(torch.int32),
            include.to(torch.bool).sum(-1).to(torch.int32))


def clause_counts_batch_packed_plain(include: torch.Tensor,
                                     literals: torch.Tensor) -> torch.Tensor:
    """K5's plain version: violations [CJ, B] i32 by a SWAR popcount."""
    from repro_torch.kernels.ref import packed_violations

    return packed_violations(include[:, None, :], literals[None, :, :])


def clause_counts_batch_replicated_packed_plain(
        include: torch.Tensor, literals: torch.Tensor) -> torch.Tensor:
    """K6's plain version: violations [R, CJ, B] i32, replica r against
    batch r % D, by a SWAR popcount."""
    from repro_torch.kernels.ref import packed_violations

    R, cj, W = include.shape
    D, B, _ = literals.shape
    inc = include.reshape(R // D, D, cj, 1, W)
    viol = packed_violations(inc, literals[None, :, None, :, :])
    return viol.reshape(R, cj, B)


def clause_counts_batch_pruned_plain(include: torch.Tensor,
                                     sel: torch.Tensor,
                                     literals: torch.Tensor):
    """K7's plain version on bytes: the gather, then K2's plain counts.
    (violations [C*M, B] i32, n_included [C*M] i32)."""
    C, J, L = include.shape
    return clause_counts_batch_plain(
        gather_include(include, sel).reshape(C * sel.shape[-1], L), literals)


def clause_counts_batch_pruned_replicated_plain(include: torch.Tensor,
                                                sel: torch.Tensor,
                                                literals: torch.Tensor):
    """The replica-first K7 on bytes: the gather, then K4's plain counts.
    (violations [R, C*M, B] i32, n_included [R, C*M] i32)."""
    R, C, J, L = include.shape
    return clause_counts_batch_replicated_plain(
        gather_include(include, sel).reshape(R, C * sel.shape[-1], L),
        literals)


def clause_counts_batch_pruned_packed_plain(include: torch.Tensor,
                                            sel: torch.Tensor,
                                            literals: torch.Tensor
                                            ) -> torch.Tensor:
    """K7 on words: the gather, then K5's plain counts. [C*M, B] i32."""
    C, J, W = include.shape
    return clause_counts_batch_packed_plain(
        gather_include(include, sel).reshape(C * sel.shape[-1], W), literals)


def clause_counts_batch_pruned_replicated_packed_plain(
        include: torch.Tensor, sel: torch.Tensor,
        literals: torch.Tensor) -> torch.Tensor:
    """The replica-first K7 on words: the gather, then K6's plain counts.
    [R, C*M, B] i32."""
    R, C, J, W = include.shape
    return clause_counts_batch_replicated_packed_plain(
        gather_include(include, sel).reshape(R, C * sel.shape[-1], W),
        literals)


def _bytes(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype not in (torch.bool, torch.uint8, torch.int8):
        raise TypeError(f"{name} must be bool/uint8/int8, got {t.dtype}")
    return t.contiguous().view(torch.uint8)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _same_device(*ts: torch.Tensor) -> None:
    if any(t.device != ts[0].device for t in ts[1:]):
        raise ValueError("kernel operands on different devices")


def _launch_counts(include, literals, R, D, cj, L):
    """One launch of K1/K3 over include [R, CJ, L], literals [D, L]."""
    _same_device(include, literals)
    inc, lit = _bytes(include, "include"), _bytes(literals, "literals")
    viol = torch.empty((R, cj), dtype=torch.int32, device=include.device)
    ninc = torch.empty((R, cj), dtype=torch.int32, device=include.device)
    _build.check(_build.library("clause_eval").clause_counts_replicated(
        inc.data_ptr(), lit.data_ptr(), viol.data_ptr(), ninc.data_ptr(),
        R, D, cj, L, _stream(inc)), "clause_counts")
    return viol, ninc


def _byte_width(L: int) -> None:
    if L > MAX_BYTE_WIDTH:
        raise ValueError(f"literal width {L} exceeds the byte kernels' "
                         f"int32 sums ({MAX_BYTE_WIDTH})")


def _launch_counts_batch(include, literals, R, D, cj, L, B):
    """One launch of K2/K4 over include [R, CJ, L], literals [D, B, L]."""
    _same_device(include, literals)
    _byte_width(L)
    inc, lit = _bytes(include, "include"), _bytes(literals, "literals")
    dev = include.device
    viol = torch.empty((R, cj, B), dtype=torch.int32, device=dev)
    ninc = torch.empty((R, cj), dtype=torch.int32, device=dev)
    _build.check(_build.library("clause_eval").clause_counts_batch_replicated(
        inc.data_ptr(), lit.data_ptr(), viol.data_ptr(), ninc.data_ptr(),
        R, D, cj, L, B, _stream(inc)), "clause_counts_batch")
    return viol, ninc


def _words(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{name} must be packed int32/uint32 words, got "
                        f"{t.dtype}")
    return t.contiguous()


def _word_width(W: int) -> None:
    if W > MAX_WORD_WIDTH:
        raise ValueError(f"word width {W} exceeds the word kernels' int32 "
                         f"sums ({MAX_WORD_WIDTH})")


def _launch_counts_packed(include, literals, R, D, cj, W, B):
    """One launch of K5/K6 over include words [R, CJ, W], literal words
    [D, B, W]."""
    _same_device(include, literals)
    _word_width(W)
    inc, lit = _words(include, "include"), _words(literals, "literals")
    viol = torch.empty((R, cj, B), dtype=torch.int32, device=inc.device)
    _build.check(_build.library("clause_eval")
                 .clause_counts_batch_packed_replicated(
        inc.data_ptr(), lit.data_ptr(), viol.data_ptr(), R, D, cj, W, B,
        _stream(inc)), "clause_counts_batch_packed")
    return viol


def _sel_ids(sel: torch.Tensor, device) -> torch.Tensor:
    """K7's ids as the kernel reads them: int32 or int64 as they come (no
    launch when they are already on ``device``), other integer types cast
    to int32 once."""
    sel = sel.to(device)
    if sel.dtype not in (torch.int32, torch.int64):
        sel = sel.to(torch.int32)
    return sel.contiguous()


def _check_pruned(include, sel, lead: tuple) -> None:
    """Shape and range checks of a K7 call."""
    if tuple(sel.shape[:-1]) != lead:
        raise ValueError(f"sel {tuple(sel.shape)} != {lead} + (M,)")
    if sel.shape[-1] < 1:
        raise ValueError("sel elects no clause (M = 0)")
    check_sel(sel, include.shape[-2])


def _launch_counts_pruned(include, sel, literals, R, D, C, J, L, B):
    """One K7 launch on bytes: include [R, C, J, L] through sel [R, C, M],
    literals [D, B, L]."""
    _same_device(include, literals)
    _byte_width(L)
    inc, lit = _bytes(include, "include"), _bytes(literals, "literals")
    dev = include.device
    ids = _sel_ids(sel, dev)
    M = ids.shape[-1]
    viol = torch.empty((R, C * M, B), dtype=torch.int32, device=dev)
    ninc = torch.empty((R, C * M), dtype=torch.int32, device=dev)
    _build.check(_build.library("clause_eval")
                 .clause_counts_batch_pruned_replicated(
        inc.data_ptr(), ids.data_ptr(), lit.data_ptr(), viol.data_ptr(),
        ninc.data_ptr(), ids.element_size(), R, D, C, M, J, L, B,
        _stream(inc)), "clause_counts_batch_pruned")
    return viol, ninc


def _launch_counts_pruned_packed(include, sel, literals, R, D, C, J, W, B):
    """One K7 launch on words: include words [R, C, J, W] through sel
    [R, C, M], literal words [D, B, W]."""
    _same_device(include, literals)
    _word_width(W)
    inc, lit = _words(include, "include"), _words(literals, "literals")
    ids = _sel_ids(sel, inc.device)
    M = ids.shape[-1]
    viol = torch.empty((R, C * M, B), dtype=torch.int32, device=inc.device)
    _build.check(_build.library("clause_eval")
                 .clause_counts_batch_pruned_packed_replicated(
        inc.data_ptr(), ids.data_ptr(), lit.data_ptr(), viol.data_ptr(),
        ids.element_size(), R, D, C, M, J, W, B, _stream(inc)),
        "clause_counts_batch_pruned_packed")
    return viol


def clause_counts(include: torch.Tensor, literals: torch.Tensor):
    """K1: include [CJ, L] x literals [L] -> (violations, n_included), both
    [CJ] i32."""
    cj, L = include.shape
    if literals.shape != (L,):
        raise ValueError(f"literals {tuple(literals.shape)} != ({L},)")
    if include.device.type == "cpu":
        return clause_counts_plain(include, literals)
    viol, ninc = _launch_counts(include, literals, 1, 1, cj, L)
    clause_counts.launches += 1
    return viol[0], ninc[0]


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
    viol, ninc = _launch_counts_batch(include, literals, 1, 1, cj, L, B)
    clause_counts_batch.launches += 1
    return viol[0], ninc[0]


clause_counts_batch.launches = 0


def clause_counts_replicated(include: torch.Tensor, literals: torch.Tensor):
    """K3: include [R, CJ, L] x literals [D, L] (D | R, replica r reads row
    r % D) -> (violations [R, CJ] i32, n_included [R, CJ] i32)."""
    R, cj, L = include.shape
    D = literals.shape[0]
    _streams(R, D)
    if literals.shape != (D, L):
        raise ValueError(f"literals {tuple(literals.shape)} != (D, {L})")
    if include.device.type == "cpu":
        return clause_counts_replicated_plain(include, literals)
    out = _launch_counts(include, literals, R, D, cj, L)
    clause_counts_replicated.launches += 1
    return out


clause_counts_replicated.launches = 0


def clause_counts_batch_replicated(include: torch.Tensor,
                                   literals: torch.Tensor):
    """K4: include [R, CJ, L] x literals [D, B, L] (D | R, replica r reads
    batch r % D) -> (violations [R, CJ, B] i32, n_included [R, CJ] i32)."""
    R, cj, L = include.shape
    D, B = literals.shape[:2]
    _streams(R, D)
    if B < 1 or literals.shape != (D, B, L):
        raise ValueError(f"literals {tuple(literals.shape)} != "
                         f"(D, B>=1, {L})")
    if include.device.type == "cpu":
        return clause_counts_batch_replicated_plain(include, literals)
    out = _launch_counts_batch(include, literals, R, D, cj, L, B)
    clause_counts_batch_replicated.launches += 1
    return out


clause_counts_batch_replicated.launches = 0


def clause_counts_batch_packed(include: torch.Tensor,
                               literals: torch.Tensor) -> torch.Tensor:
    """K5: include words [CJ, W] x literal words [B, W] -> violations
    [CJ, B] i32."""
    cj, W = include.shape
    B = literals.shape[0]
    if B < 1 or literals.shape != (B, W):
        raise ValueError(f"literals {tuple(literals.shape)} != (B>=1, {W})")
    if include.device.type == "cpu":
        return clause_counts_batch_packed_plain(include, literals)
    viol = _launch_counts_packed(include, literals, 1, 1, cj, W, B)
    clause_counts_batch_packed.launches += 1
    return viol[0]


clause_counts_batch_packed.launches = 0


def clause_counts_batch_replicated_packed(include: torch.Tensor,
                                          literals: torch.Tensor
                                          ) -> torch.Tensor:
    """K6: include words [R, CJ, W] x literal words [D, B, W] (D | R,
    replica r reads batch r % D) -> violations [R, CJ, B] i32."""
    R, cj, W = include.shape
    D, B = literals.shape[:2]
    _streams(R, D)
    if B < 1 or literals.shape != (D, B, W):
        raise ValueError(f"literals {tuple(literals.shape)} != "
                         f"(D, B>=1, {W})")
    if include.device.type == "cpu":
        return clause_counts_batch_replicated_packed_plain(include, literals)
    viol = _launch_counts_packed(include, literals, R, D, cj, W, B)
    clause_counts_batch_replicated_packed.launches += 1
    return viol


clause_counts_batch_replicated_packed.launches = 0


def clause_counts_batch_pruned(include: torch.Tensor, sel: torch.Tensor,
                               literals: torch.Tensor):
    """K7 on bytes: include [C, J, L] x sel [C, M] x literals [B, L] ->
    (violations [C*M, B] i32, n_included [C*M] i32) of the elected
    clauses, row c*M + m for clause sel[c, m]."""
    C, J, L = include.shape
    _check_pruned(include, sel, (C,))
    B = literals.shape[0]
    if B < 1 or literals.shape != (B, L):
        raise ValueError(f"literals {tuple(literals.shape)} != (B>=1, {L})")
    if include.device.type == "cpu":
        return clause_counts_batch_pruned_plain(include, sel, literals)
    viol, ninc = _launch_counts_pruned(include, sel[None], literals, 1, 1, C,
                                       J, L, B)
    clause_counts_batch_pruned.launches += 1
    return viol[0], ninc[0]


clause_counts_batch_pruned.launches = 0


def clause_counts_batch_pruned_replicated(include: torch.Tensor,
                                          sel: torch.Tensor,
                                          literals: torch.Tensor):
    """K7 on bytes, replica-first: include [R, C, J, L] x sel [R, C, M] x
    literals [D, B, L] (replica r reads batch r % D and its own ``sel[r]``)
    -> (violations [R, C*M, B] i32, n_included [R, C*M] i32)."""
    R, C, J, L = include.shape
    D, B = literals.shape[:2]
    _streams(R, D)
    _check_pruned(include, sel, (R, C))
    if B < 1 or literals.shape != (D, B, L):
        raise ValueError(f"literals {tuple(literals.shape)} != "
                         f"(D, B>=1, {L})")
    if include.device.type == "cpu":
        return clause_counts_batch_pruned_replicated_plain(include, sel,
                                                           literals)
    out = _launch_counts_pruned(include, sel, literals, R, D, C, J, L, B)
    clause_counts_batch_pruned_replicated.launches += 1
    return out


clause_counts_batch_pruned_replicated.launches = 0


def clause_counts_batch_pruned_packed(include: torch.Tensor,
                                      sel: torch.Tensor,
                                      literals: torch.Tensor) -> torch.Tensor:
    """K7 on words: include words [C, J, W] x sel [C, M] x literal words
    [B, W] -> violations [C*M, B] i32."""
    C, J, W = include.shape
    _check_pruned(include, sel, (C,))
    B = literals.shape[0]
    if B < 1 or literals.shape != (B, W):
        raise ValueError(f"literals {tuple(literals.shape)} != (B>=1, {W})")
    if include.device.type == "cpu":
        return clause_counts_batch_pruned_packed_plain(include, sel, literals)
    viol = _launch_counts_pruned_packed(include, sel[None], literals, 1, 1,
                                        C, J, W, B)
    clause_counts_batch_pruned_packed.launches += 1
    return viol[0]


clause_counts_batch_pruned_packed.launches = 0


def clause_counts_batch_pruned_replicated_packed(include: torch.Tensor,
                                                 sel: torch.Tensor,
                                                 literals: torch.Tensor
                                                 ) -> torch.Tensor:
    """K7 on words, replica-first: include words [R, C, J, W] x sel
    [R, C, M] x literal words [D, B, W] -> violations [R, C*M, B] i32."""
    R, C, J, W = include.shape
    D, B = literals.shape[:2]
    _streams(R, D)
    _check_pruned(include, sel, (R, C))
    if B < 1 or literals.shape != (D, B, W):
        raise ValueError(f"literals {tuple(literals.shape)} != "
                         f"(D, B>=1, {W})")
    if include.device.type == "cpu":
        return clause_counts_batch_pruned_replicated_packed_plain(
            include, sel, literals)
    viol = _launch_counts_pruned_packed(include, sel, literals, R, D, C, J,
                                        W, B)
    clause_counts_batch_pruned_replicated_packed.launches += 1
    return viol


clause_counts_batch_pruned_replicated_packed.launches = 0


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


def clause_eval_replicated(include: torch.Tensor, literals: torch.Tensor, *,
                           training: bool) -> torch.Tensor:
    """Kernel-backed replica-first clause outputs [R, C, J] bool (K3)."""
    R, C, J, L = include.shape
    viol, n_inc = clause_counts_replicated(include.reshape(R, C * J, L),
                                           literals)
    fired = viol == 0
    empty = n_inc == 0
    return torch.where(empty, training, fired).reshape(R, C, J)


def clause_eval_batch_replicated(include: torch.Tensor,
                                 literals: torch.Tensor, *,
                                 training: bool) -> torch.Tensor:
    """Kernel-backed replica-first batch clause outputs [R, B, C, J] bool
    (K4)."""
    R, C, J, L = include.shape
    B = literals.shape[1]
    viol, n_inc = clause_counts_batch_replicated(
        include.reshape(R, C * J, L), literals)
    fired = (viol == 0).transpose(1, 2).reshape(R, B, C, J)
    empty = (n_inc == 0).reshape(R, 1, C, J)
    return torch.where(empty, training, fired)


def clause_eval_batch_packed(include_packed: torch.Tensor,
                             literals_packed: torch.Tensor, *,
                             training: bool) -> torch.Tensor:
    """Kernel-backed packed batch clause outputs [B, C, J] bool (K5);
    emptiness from the include words."""
    C, J, W = include_packed.shape
    B = literals_packed.shape[0]
    viol = clause_counts_batch_packed(include_packed.reshape(C * J, W),
                                      literals_packed)
    fired = (viol == 0).T.reshape(B, C, J)
    empty = ~torch.any(include_packed != 0, dim=-1)
    return torch.where(empty[None], training, fired)


def clause_eval_batch_replicated_packed(include_packed: torch.Tensor,
                                        literals_packed: torch.Tensor, *,
                                        training: bool) -> torch.Tensor:
    """Kernel-backed packed replica-first batch outputs [R, B, C, J] bool
    (K6); emptiness from the include words."""
    R, C, J, W = include_packed.shape
    B = literals_packed.shape[1]
    viol = clause_counts_batch_replicated_packed(
        include_packed.reshape(R, C * J, W), literals_packed)
    fired = (viol == 0).transpose(1, 2).reshape(R, B, C, J)
    empty = ~torch.any(include_packed != 0, dim=-1).reshape(R, 1, C, J)
    return torch.where(empty, training, fired)


def _empty_elected(include_packed: torch.Tensor,
                   sel: torch.Tensor) -> torch.Tensor:
    """Emptiness of the elected clauses [.., C, M]: no include word set."""
    empty = ~torch.any(include_packed != 0, dim=-1)            # [.., C, J]
    return torch.take_along_dim(
        empty, sel.to(include_packed.device, torch.int64), dim=-1)


def clause_eval_batch_pruned(include: torch.Tensor, sel: torch.Tensor,
                             literals: torch.Tensor, *,
                             training: bool) -> torch.Tensor:
    """Kernel-backed budgeted outputs [B, C, M] bool (K7 on bytes)."""
    C, J, L = include.shape
    B = literals.shape[0]
    M = sel.shape[-1]
    viol, n_inc = clause_counts_batch_pruned(include, sel, literals)
    fired = (viol == 0).T.reshape(B, C, M)
    empty = (n_inc == 0).reshape(C, M)
    return torch.where(empty[None], training, fired)


def clause_eval_batch_pruned_replicated(include: torch.Tensor,
                                        sel: torch.Tensor,
                                        literals: torch.Tensor, *,
                                        training: bool) -> torch.Tensor:
    """Kernel-backed replica-first budgeted outputs [R, B, C, M] bool (K7
    on bytes)."""
    R, C, J, L = include.shape
    B = literals.shape[1]
    M = sel.shape[-1]
    viol, n_inc = clause_counts_batch_pruned_replicated(include, sel,
                                                        literals)
    fired = (viol == 0).transpose(1, 2).reshape(R, B, C, M)
    empty = (n_inc == 0).reshape(R, 1, C, M)
    return torch.where(empty, training, fired)


def clause_eval_batch_pruned_packed(include_packed: torch.Tensor,
                                    sel: torch.Tensor,
                                    literals_packed: torch.Tensor, *,
                                    training: bool) -> torch.Tensor:
    """Kernel-backed packed budgeted outputs [B, C, M] bool (K7 on words);
    emptiness from the elected include words."""
    C, J, W = include_packed.shape
    B = literals_packed.shape[0]
    M = sel.shape[-1]
    viol = clause_counts_batch_pruned_packed(include_packed, sel,
                                             literals_packed)
    fired = (viol == 0).T.reshape(B, C, M)
    empty = _empty_elected(include_packed, sel)
    return torch.where(empty[None], training, fired)


def clause_eval_batch_pruned_replicated_packed(include_packed: torch.Tensor,
                                               sel: torch.Tensor,
                                               literals_packed: torch.Tensor,
                                               *, training: bool
                                               ) -> torch.Tensor:
    """Kernel-backed packed replica-first budgeted outputs [R, B, C, M]
    bool (K7 on words); emptiness from the elected include words."""
    R, C, J, W = include_packed.shape
    B = literals_packed.shape[1]
    M = sel.shape[-1]
    viol = clause_counts_batch_pruned_replicated_packed(
        include_packed, sel, literals_packed)
    fired = (viol == 0).transpose(1, 2).reshape(R, B, C, M)
    empty = _empty_elected(include_packed, sel).reshape(R, 1, C, M)
    return torch.where(empty, training, fired)
