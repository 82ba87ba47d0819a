"""Work of one learning step as functions of its shapes, and the peaks.

The counts are what the step's mathematics needs, whatever implements
it: each input byte read once and each output byte written once. They
name the system's kernels only to say which share of the step a count
covers. R machines (replicas) of C classes x J clauses x L literals
(L = 2f) learn from D data streams (D divides R; replicas of one stream
share its rows and its uniform draws).

Peaks of one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM3
and 1,979 TOP/s in int8.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def automata(C: int, J: int, L: int) -> int:
    """Tsetlin automata of one machine: C * J * L."""
    return C * J * L


def clause_bytes(R: int, D: int, C: int, J: int, L: int) -> int:
    """Clause evaluation in training mode (K3): the include plane (a byte
    an automaton) and the literals (a byte each) in; the violation and
    include counts (int32 a clause) out."""
    return R * automata(C, J, L) + D * L + 2 * 4 * R * C * J


def feedback_bytes(R: int, D: int, C: int, J: int, L: int,
                   state_bytes: int) -> int:
    """The fused Type I / II update (K9): the bank in and out, the
    literals, three control bytes a clause and two float32 probabilities
    a replica. The uniform draws are not counted: the update needs the
    random bits, not a plane of them in memory, and where they come from
    is the implementation's choice (``uniforms`` counts them)."""
    n = automata(C, J, L)
    return 2 * state_bytes * R * n + D * L + 3 * R * C * J + 2 * 4 * R


def uniforms(D: int, C: int, J: int, L: int) -> int:
    """Uniforms one step draws: a [C, J, L] plane a stream, plus C for
    the non-target class and 2J for the two clause selections."""
    return D * (automata(C, J, L) + C + 2 * J)


def learn_ops(R: int, C: int, J: int, L: int) -> int:
    """Operations of one step of R machines: one literal test and one
    automaton update an automaton (int8-sized work)."""
    return 2 * R * automata(C, J, L)
