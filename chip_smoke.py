#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-from DIR
    python3 chip_smoke.py --tm-from DIR

The second form imports the port from DIR (a tree's ``src``, this one's
or a parent's unpacked beside it, to time both trees' kernels with one
script on one card) and runs only phases 1-3's K1-K4, K8 and K9 part, the
launch floor, the times of the two K7 byte entries, of K5, K6 and the two
K7 word entries (each held to its plain version first), and two serves
(the packed K = 1 service and the packed K = 16 tunable fleet, 1024 rows,
on random banks); it prints no ok line. The third imports the port from
DIR likewise and runs only the TM service's phases ``fleet``,
``fleet_iris``, ``tunable``, ``residency`` and ``profile_fleet`` (their
checks included), to hold two trees' service readings against each
other on one card; it prints no ok line.

Phases, each with its seconds:

1. device  -- the card, and its name and power limit from nvidia-smi;
2. build   -- the CUDA kernels built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all started together);
3. parity  -- every kernel held to its plain PyTorch version with
   ``torch.equal``: K1 ``clause_counts``, K2 ``clause_counts_batch`` and K8
   ``feedback_plane`` at the iris, ragged and full MNIST widths and at
   L = 1, 15, 16, 17, 98 (K8 on int8 and int16 banks); K3
   ``clause_counts_replicated``, K4 ``clause_counts_batch_replicated``
   (B = 1, 7, 150) and K9 ``feedback_plane_replicated`` (int8 and int16)
   at (R, D, CJ, L) = (6, 3, 48, 32), (3, 1, 12, 33), (4, 2, 12, 513),
   (8, 8, 640, 1568), (16, 4, 640, 1568) and (4, 2, 12, L) at the same
   five widths. K1, K3, K8 and K9 are held at every shape on aligned
   operands, on views one element off a 16-byte boundary and with only
   the literals off it, so both their vector and scalar paths run. K2,
   K4 and K7 on bytes (one int8 tensor-core body) are held at L in
   BYTE_L (1 to 1568) x B in BYTE_B (1 to 1024) x the same placements x
   bool, uint8 and int8 operands whose set bytes are 1, 2, 255 or -1,
   each call one launch, and on the body's 128 x 128 tiles at R = 16;
   then ``b1_probe``: the rates of ``mma.sync`` m16n8k256 .b1
   AND-popcount products and of ``__popc(a & ~b)`` in bit operations a
   clock an SM (``csrc/probe.cu``), the faster setting the word kernels'
   bound; ``parity_words``: K5, K6 and K7 on words (one b1 tensor-core
   body) at W in WORD_W (1 to 700 words) x B in BYTE_B x aligned operands
   and operands 4 and 8 bytes off x random, all-ones and tail-bit words,
   K7 on int32 and int64 selections holding ids 0 and J - 1 and also
   against gather + K6, each call one launch, and on the 128 x 128 tiles
   at R = 16; then ``one_launch``: torch.profiler sees one CUDA kernel in
   a K2 call, a K5 call and a K = 1 K7 call on bytes and on words. Beside
   each, at the main path's shapes, the median time of the kernel (CUDA
   graphs of back-to-back launches, timed by CUDA events), of its plain
   version and, for the clause counts, of one float32
   ``torch.matmul``/``torch.bmm`` of the same contraction (a yardstick the
   port never calls; K2 also beside ``torch._int_mm`` of the int8
   contraction); then the launch floor, the time of a one-element
   in-place ``add_`` timed the same way. Then ``phase_parity_packed``: K5 ``clause_counts_batch_packed`` and
   K6 ``clause_counts_batch_replicated_packed`` against their plain
   versions and against K2/K4 on the same problem unpacked, at
   f {16, 31, 33, 49, 196, 784} x CJ {12, 48, 640} x B {1, 7, 150, 1024}
   and (R, D) {(1, 1), (4, 2), (3, 3), (16, 16), (16, 1)}, each bank with
   an all-empty and an all-include clause row; K5 and K6 timed beside K2/K4
   and their plain versions, bound by their bytes or their bit operations
   at the b1 peak that ``b1_probe`` measured. Then
   ``phase_parity_pruned``: K7, the four pruned entries
   ``clause_counts_batch_pruned{,_packed,_replicated,_replicated_packed}``,
   against their plain versions, against the gather + K2/K4/K5/K6 kernels
   and packed against unpacked, at f {16, 31, 33, 784} x (R, D) {(1, 1),
   (4, 2), (16, 1), (16, 16)} x B {1, 7, 250, 1024} x M {1, 64, 128}
   (permutation prefixes and ids with repeats) on the OVERPROVISIONED
   10 x 128 clause plane; timed at f = 784, B = 1024, M = 32 and 128,
   beside gather + K2/K4/K5/K6 and the full-bank kernel;
4. service -- the K = 1 ``TMService`` at the full MNIST width (f = 784):
   offline_train, submit + tick until drained with an ``on_chunk``
   monitor, and a 1024-row serve, through the kernels (backend "auto");
   then the same sequence with backend "ref" on the card, and packed
   (``ServiceConfig(packed=True)``), both of which must give the same TA
   bank, keys, reports, accuracies and predictions bit for bit. K1, K2
   and K8 must each have launched during the "auto" run, and K5 exactly
   as often as the packed run implies;
5. paper   -- the paper's iris setup at full scale through the
   replica-first engine: ``CrossValRun.sweep`` over 120 orderings x s
   {1.375, 2.0, 3.0} x T {5, 10, 15} (R = 1080), 10 epochs, then the
   figure runs through ``eval.usecases.run_system`` at SystemConfig(10,
   16): online learning (Fig 4, §5.1) over all 120 block orderings, and
   the reference's full-scale pairs over 24 (tests/test_paper_figures.py):
   class 0 introduced at cycle 5, frozen and online (Figs 6/7, §5.2), and
   75% of the TAs stuck at 0 from cycle 5, frozen and online (Figs 8/9,
   §5.3). Each run on backend "auto" and on "ref", in worker processes
   (five at a time); banks, accuracies and activity must be bitwise
   equal, K3/K4/K9 must launch as the code implies, and the curves must
   pass the reference's bands (the Fig-4 gains; the Fig 6-9 drops, flat
   frozen curves, recovery and online-over-frozen gaps). Then
   ``examples``: seven ``examples/*_torch.py`` through their ``main``
   on the card, each in a worker process, all at once (quickstart,
   serve_fleet, mnist_scale --side 28, tunable_serving, serve_lm,
   train_lm --small, online_lm_adaptation; checkpoints in a temporary
   directory): each returns, prints its lines (echoed), gives finite
   accuracies and losses in range and launches the kernels on its path;
6. wide    -- the same engine at the full MNIST width (f = 784):
   ``run_orderings`` with O = 8, SystemConfig(2, 2), and a sweep of
   O = 4 x s {1.5, 2.0} x T {24, 32} (R = 16), 1 epoch; "auto" then
   "ref", bitwise equal. K3, K4 and K9 must each have launched exactly as
   often as the code says during the "auto" runs of phases 5 and 6;
7. fleet   -- ``TMService(replicas=16, packed=True)`` at f = 784 with a
   4 x 4 grid of per-replica s and T: offline_train, each member's own
   stream through ``submit_rows`` and tick until drained, a shared 1024-row
   serve and a [16, 64] per-member serve; "auto", "ref" and unpacked, all
   bitwise equal, with K3, K9 and K6 launched exactly as the code says;
   then ``fleet_iris``: the reference's fleet geometry (K = 8 iris
   machines, 64 points, chunk 16) through ``OnlineFleet`` ("auto" and
   "ref") and through 8 K = 1 services, all bitwise equal;
8. tunable -- runtime-tunable serving: the OVERPROVISIONED preset (f =
   784, J = 128) as a K = 16 fleet (4 x 4 s x T), offline-trained 200
   rows x 2 epochs, calibrated on the train split, serving the 250-row
   test split and a 1024-row batch at budgets {1, 0.5, 0.25, 0.125} x
   weight_bits {0, 4} x early exit {off, group 16}: "auto" unpacked and
   packed, "ref" unpacked, all bitwise equal; budget 1.0 with unit
   weights equal to plain serve; ``serve_replicas`` equal to those rows;
   member 0 through ``predict_batch_pruned``/``analyze_pruned``; save ->
   restore -> serve and -> one drained tick equal to never stopping; the
   adapt rule sheds and recovers the budget. Then ``residency``: host-
   spilled replicas through ``TMService(resident=R)``, each path bitwise
   against an always-resident twin on the card (budgets masked by
   ``buffered > 0``): iris at K = 4096 on 64 slots (the reference
   benchmark's largest row) and MNIST at f = 784, packed, K = 256 on 32
   slots, batched moves against the synchronous ones, timed (points/s,
   ``speedup_vs_percohort``, evict and activate ms a replica, the move
   rate beside pinned copies); ``resident="auto"`` from dense to sparse
   traffic; tunable ``serve_replicas`` under residency (K7 replicated);
   save -> restore as saved -> continue. K3, K4, K6, K7 replicated and K9
   must launch as the code implies. Then ``traffic``: the iris
   service at the reference's traffic geometry (K = 4 producers) with an
   adapting tuner, steady and fault_injected threaded on the card, each
   replayed from one thread to the same fingerprint. Then ``mesh``
   (``phase_mesh``): the replica-axis mesh, 4 slabs on card 0 (and all
   the cards where there are several), each sharded run bitwise against
   the same run without a mesh: the packed K = 256 MNIST fleet at f = 784
   (resident ticks, calibration, K7 serves on words; then
   ``resident="auto"``: the trajectory and the residency map),
   ``CrossValRun(mesh).sweep`` on iris at 120 orderings x 2 x 2 and at 4
   orderings x 2 cells (one gathered stream row a replica), and an
   unpacked K = 16 tunable fleet (K7 on bytes); it prints the sharded
   runs' K3/K4/K6/K7/K9 launches (each > 0) and a tick's ms with and
   without the slabs. Then ``lm``: the
   dense LM serving path (``phase_lm``; no CUDA kernel of its own):
   gemma3-1b at full width and depth, bf16, through ``Engine.generate``
   (4 x 1024-token prompts, 64 new tokens: the streaming-softmax prefill
   and a wrapped 512-token window) with prefill ms, decode ms a step,
   tokens/s, peak memory and a torch.profiler window of 8 decode steps;
   the float32 checks at full width (prefill -> decode == forward,
   ``generate`` == a full-forward greedy re-run); the four other dense
   archs at full width, one pattern repetition deep; the card against
   the CPU; what ``layers.silu``'s bf16 expansion costs granite-8b (one
   layer) against one ``torch.sigmoid``, in decode launches and ms and
   in train step ms and peak memory. Then ``lm_train`` (``phase_lm_train``; no CUDA kernel of its
   own): gemma3-1b trained at full width and depth, bf16, remat dots,
   AdamW, B = 4 x 1024 tokens: remat's gradients equal no remat's bit for
   bit, step ms, tokens/s, peak memory with and without remat, a
   torch.profiler window of 2 steps, the step split into gradient pass,
   cross-entropy and optimizer, a float32 SGD descent step, and the
   streaming-softmax backward and a 6-layer train step against the CPU
   (the launcher's save and resume at 6 layers since PR 24).
   Then ``lm_moe_ssd`` (``phase_lm_moe_ssd``; no CUDA kernel of its own):
   ``launch.serve --full`` for olmoe-1b-7b and mamba2-780m; bf16 serving
   through ``Engine.generate`` of 4 x 1024-token prompts, olmoe-1b-7b and
   mamba2-780m at full width, 4 of 16 and 12 of 48 layers (64 new tokens;
   cut in PR 24 for the script's time) and arctic-480b at
   full width, one layer, bf16 parameters (16 new tokens): prefill ms,
   decode ms a step, tokens/s, peak memory, the MoE slots dropped by
   capacity, one layer's time split into its parts, 8 profiled decode
   steps; the card against the CPU at full width, 2 layers (arctic 1),
   the MoE routing integers equal, and mamba2's prefill -> decode
   against a forward over S + chunk tokens. Then ``lm_moe_ssd_train``:
   ``launch.train --full`` for mamba2-780m and olmoe-1b-7b (``--layers
   4``), bf16 training (AdamW, 4 x 1024 tokens a step) of mamba2-780m at
   12 of 48 layers and olmoe-1b-7b at 4 layers with step ms, tokens/s, peak
   memory and a 2-step profile, and one train step of each against the
   CPU (olmoe at 1 layer, mamba2 at 2). Then ``lm_rglru_cross``
   (``phase_lm_rglru_cross``; no CUDA kernel of its own): ``launch.serve
   --full`` for recurrentgemma-9b (the launcher and ``Engine.generate``
   refuse the vlm, whose prefill needs ``cross_embeds``); bf16 serving of
   4 x 1024-token prompts and 64 new tokens at full width, 14 of 38 and
   10 of 40 layers (PR 24's cut), recurrentgemma-9b through
   ``Engine.generate`` and llama-3.2-vision-11b
   through ``Transformer.prefill`` with its 1601 stub image embeddings and
   ``decode_step``: prefill ms, decode ms a step, tokens/s, peak memory,
   one layer of each kind timed (the RG-LRU's scan, gates and MLP; CROSS
   beside GLOBAL), 8 profiled decode steps; the card against the CPU one
   super-block deep (float64 within 1e-10, prefill -> decode == forward).
   Then ``lm_rglru_cross_train``: ``launch.train --full --layers 5`` and
   8 bf16 AdamW steps of each at 5 layers (step ms, tokens/s, peak
   memory, a 2-step profile). The CROSS gates and the RG-LRU's
   constant-init biases and Lambda are drawn off their inits in every
   check. Then ``lm_attention_memory`` (``phase_lm_attention_memory``;
   no CUDA kernel of its own): one layer's attention at full width, B =
   2, S = 4096: the vlm's CROSS attention over its 1601 image tokens in
   query blocks against the dense path (bf16 and float32: output and
   gradients within the LM tolerances, each path's memory increment and
   ms), and granite-8b's streaming attention bit for bit against the
   frozen out-of-place code of ``tests/test_torch_lm_attention_memory.py``
   (bf16 with and without a window, float32), both codes' increments and
   ms. Then ``lm_mesh`` (``phase_lm_mesh``; no CUDA kernel of its
   own): 4 ``torch.distributed`` ranks, on one card over the staged
   backend (a card a rank with NCCL where there are 4), train gemma3-1b
   at full width, 6 of 26 layers, B = 4 x 1024, laid out over a (2, 2)
   (data, model) mesh by the reference's rules: 2 float32 steps against
   the unsharded port on the same card (losses within 1e-5 relative), a
   collective checkpoint resumed on (4, 1) (parameters and moments
   within 1e-4 of each leaf's range of the unsharded state) and one
   more step held the same way, a timed bf16 step beside the unsharded
   one (each
   rank's peak, the staged collectives' calls and bytes a step), and
   olmoe-1b-7b's loss at full width, one layer. Then ``lm_mesh_serve``
   (``phase_lm_mesh_serve``): the same 4 ranks run the dry run's serving
   cells (``launch/dryrun.build_cell``) on a KV cache laid out by
   ``cache_shardings``, each rank writing and attending over its own
   block: gemma3-1b at full width, 6 of 26 layers, 4 prompts of 4096
   tokens and 16 given tokens on (2, 2) with the SP decode policy,
   float32 and bf16 against the unsharded port on the card; olmoe-1b-7b
   one layer, experts over data, its routing integers equal; mamba2-780m
   2 layers, one sharded float32 train step against the unsharded one;
   then the dry run's TM cell, slab 0 (32 replicas) of the 8192-replica
   grid through K3/K4/K9 (counts from 0, each must move), with its peak;
9. profile -- torch.profiler over one more 16-point drain chunk of the
   service, over one offline epoch of the f = 784, O = 8 engine, and over
   one drain chunk of the K = 16 fleet: wall time, device busy time, idle
   share, launches (per step) and the top kernels;
10. kernels -- one JSON line with each kernel's launches (phase 4 for K1,
   K2, K5, K8; phase 6 for K3, K4, K9; phase 7 for K6; phase 8 for the
   four K7 entries), error and times.

The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits nonzero. Without a CUDA device, or without the
port's sources beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 2023
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12      # dense int8 tensor-core rate
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
FULL = (640, 1568)            # MNIST preset: 10 x 64 clause rows, 2 x 784 literals
SHAPES = [(48, 32), (12, 33), (12, 513), FULL]
# Widths at the K1/K3/K8/K9 path boundaries: the vector path takes
# L % 16 == 0 with 16-byte-aligned operands, the scalar path the rest.
EDGE_L = (1, 15, 16, 17, 98)
# K1/K3/K8/K9 are held on three placements of their operands (the
# storage offset of each in elements): all aligned; all one element off a
# 16-byte boundary (the scalar path at any width); only the literals off.
PLACEMENTS = (("aligned", 0, 0), ("offset=1", 1, 1), ("literals+1", 0, 1))
# K2, K4 and K7 on bytes (one int8 tensor-core body) are held at widths
# and batches on its boundaries: the 16-byte cp.async segment, the 64-byte
# chunk, the 8-column MMA tile and the 64-column block tile; on bool
# operands and on bytes whose set values are 1, 2 or 255 (uint8) or 1, 2
# or -1 (int8), since any nonzero byte counts as 1.
BYTE_L = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 98, 513, 1568)
BYTE_B = (1, 7, 8, 9, 150, 1024)
BYTE_KINDS = ("bool", "uint8", "int8")
# Grids of 8 or more 64 x 64 tiles an SM take the body's 128 x 128 tiles:
# held at R = 16 banks of 300 ragged rows against B = 1000.
BIG_R, BIG_ROWS, BIG_B = 16, 300, 1000
# Replica-first shapes (R, D, CJ, L); WIDE is the f = 784 system's step.
WIDE = (8, 8) + FULL
REP_SHAPES = [(6, 3, 48, 32), (3, 1, 12, 33), (4, 2, 12, 513), WIDE,
              (16, 4) + FULL]
B_ANALYSIS = 150              # one fused three-set analysis: 30 + 60 + 60 rows


# K5, K6 and K7 on words (one b1 tensor-core body) are held at word widths
# on its edges -- the 4-, 8- and 16-byte copies (W odd, W % 4 == 2, W % 4
# == 0), the 8-word b1 step, the 16-word chunk, and 700 words, beyond the
# old counting kernel's shared-memory cap -- at BYTE_B batches, on aligned
# operands and on operands 4 and 8 bytes off alignment, and on three kinds
# of words: random; all-ones include words against literal rows of zeros,
# ones and random words (sums up to 32 W); random include words whose
# last word has its high bits set against literals whose last word has
# them clear (include tail bits, as past a packed width).
WORD_W = (1, 2, 3, 7, 8, 9, 50, 98, 700)
WORD_KINDS = ("random", "ones", "tail")
# (name, storage offset of the bank, of the literals), in int32 words
WORD_PLACEMENTS = (("aligned", 0, 0), ("4 bytes off", 1, 1),
                   ("8 bytes off", 2, 2), ("literals 8 bytes off", 0, 2))
PACKED_F = (16, 31, 33, 49, 196, 784)   # W = 2, 2, 4, 4, 14, 50 words
PACKED_CJ = (12, 48, 640)
PACKED_B = (1, 7, 150, 1024)
PACKED_RD = ((1, 1), (4, 2), (3, 3), (16, 16), (16, 1))
FLEET_K = 16
FLEET_S = (2.0, 3.0, 3.9, 5.0)          # a 4 x 4 grid of per-replica ports
FLEET_T = (10, 15, 20, 25)
# K7 parity grid: the OVERPROVISIONED clause plane (10 classes x 128
# clauses) at f {16, 31, 33, 784}, (R, D) and B as listed.
PRUNED_C, PRUNED_J = 10, 128
PRUNED_F = (16, 31, 33, 784)
PRUNED_RD = ((1, 1), (4, 2), (16, 1), (16, 16))
PRUNED_B = (1, 7, 250, 1024)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(torch, fn, inner: int = 20, reps: int = 15) -> float:
    """Median device time of one ``fn()``: a CUDA graph of ``inner``
    back-to-back calls, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def at(torch, t, offset: int):
    """``t`` as a contiguous view ``offset`` elements into a larger tensor
    on its device (offset 0: ``t`` itself)."""
    if not offset:
        return t
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


def placements(torch) -> list:
    """(name, place an operand, place the literals) for each of
    PLACEMENTS."""
    return [(what, lambda t, o=o: at(torch, t, o),
             lambda t, o=lo: at(torch, t, o)) for what, o, lo in PLACEMENTS]


def byte_operand(torch, np, rng, shape, p, kind, dev, bank=False):
    """A random 0/1 plane at density ``p`` as ``kind`` (BYTE_KINDS): bools,
    or bytes whose set values are drawn from 1, 2 and 255 (uint8) or 1, 2
    and -1 (int8). A ``bank`` gets an all-empty first and an all-include
    last row (axis -2)."""
    bits = rng.random(shape) < p
    if kind == "bool":
        t = torch.from_numpy(bits)
    else:
        vals = rng.choice((1, 2, 255) if kind == "uint8" else (1, 2, -1),
                          size=shape)
        t = torch.from_numpy(np.where(bits, vals, 0).astype(kind))
    if bank:
        t[..., 0, :] = 0
        t[..., -1, :] = {"bool": 1, "uint8": 255, "int8": -1}[kind]
    return t.to(dev)


def byte_edges(torch, np, rng, dev, hold, bank_shape, lit_lead,
               batches=BYTE_B):
    """Hold ``hold(inc, lits, view, lview, what)`` at every BYTE_L x
    BYTE_KINDS x ``batches`` x PLACEMENTS: a bank [*bank_shape, L] with an
    empty and an all-include row, literals [*lit_lead, B, L]."""
    for L in BYTE_L:
        for kind in BYTE_KINDS:
            inc = byte_operand(torch, np, rng, tuple(bank_shape) + (L,), 0.1,
                               kind, dev, bank=True)
            for B in batches:
                lits = byte_operand(torch, np, rng,
                                    tuple(lit_lead) + (B, L), 0.5, kind, dev)
                for what, view, lview in placements(torch):
                    hold(inc, lits, view, lview,
                         f"L={L} {kind} B={B} {what}")


def int_mm_ms(torch, a, b):
    """(ms, None): the time of one ``torch._int_mm(a, b)`` (int8 x int8 ->
    int32), a yardstick the port never calls; (None, why) where it does
    not run on this card."""
    try:
        torch._int_mm(a, b)
        torch.cuda.synchronize()
    except Exception as e:  # reported in the record, never a fallback
        return None, f"{type(e).__name__}: {e}".splitlines()[0][:160]
    return time_ms(torch, lambda: torch._int_mm(a, b)), None


def k7_bytes_work(R, C, M, f, B):
    """(bytes, int8 operations) of K7 on bytes: the R*C*M elected include
    rows, their int32 ids, the B literal rows, the int32 violations and
    n_included; the contraction with a ones column, as K2's."""
    rows, L = R * C * M, 2 * f
    return (rows * L + rows * 4 + B * L + rows * B * 4 + rows * 4,
            2.0 * rows * L * (B + 1))


def launch_floor_ms(torch) -> float:
    """The device time of the smallest launch: a one-element in-place
    ``add_``, timed as the kernels are."""
    one = torch.zeros(1, device="cuda")
    return time_ms(torch, lambda: one.add_(1))


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wrappers(ce, fb) -> tuple:
    """Every kernel wrapper (each counts its own launches)."""
    return (ce.clause_counts, ce.clause_counts_batch,
            ce.clause_counts_replicated, ce.clause_counts_batch_replicated,
            ce.clause_counts_batch_packed,
            ce.clause_counts_batch_replicated_packed,
            ce.clause_counts_batch_pruned,
            ce.clause_counts_batch_pruned_replicated,
            ce.clause_counts_batch_pruned_packed,
            ce.clause_counts_batch_pruned_replicated_packed,
            fb.feedback_plane, fb.feedback_plane_replicated)


def zero_counters(ce, fb) -> None:
    """Every kernel wrapper's launch count to 0."""
    for k in wrappers(ce, fb):
        k.launches = 0


def counters(ce, fb) -> dict:
    return {k.__name__: k.launches for k in wrappers(ce, fb)}


def max_sm_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def word_operand(torch, np, rng, shape, kind, dev, bank=False):
    """uint32 words [*shape] of ``kind`` (WORD_KINDS) as the port's int32
    words on ``dev``: a ``bank``'s include words, else literal words. A
    bank gets an all-zero (empty) first and an all-ones last row (axis
    -2)."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    if bank:
        if kind == "ones":
            w[...] = 0xFFFFFFFF
        elif kind == "tail":
            w[..., -1] |= np.uint32(0xFFFF0000)
        w[..., 0, :] = 0
        w[..., -1, :] = 0xFFFFFFFF
    elif kind == "ones":
        w[..., 0::3, :] = 0
        w[..., 1::3, :] = 0xFFFFFFFF
    elif kind == "tail":
        w[..., -1] &= np.uint32(0x0000FFFF)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def word_edges(torch, np, rng, dev, hold, bank_shape, lit_lead,
               batches=BYTE_B):
    """Hold ``hold(inc, lits, placed, what)`` at every WORD_W x WORD_KINDS
    x ``batches``: a bank [*bank_shape, W], literals [*lit_lead, B, W],
    and ``placed`` the (name, place the bank, place the literals) of
    WORD_PLACEMENTS."""
    placed = [(what, lambda t, o=o: at(torch, t, o),
               lambda t, o=lo: at(torch, t, o))
              for what, o, lo in WORD_PLACEMENTS]
    for W in WORD_W:
        for kind in WORD_KINDS:
            inc = word_operand(torch, np, rng, tuple(bank_shape) + (W,),
                               kind, dev, bank=True)
            for B in batches:
                lits = word_operand(torch, np, rng,
                                    tuple(lit_lead) + (B, W), kind, dev)
                hold(inc, lits, placed, f"W={W} {kind} B={B}")


def by_replica(torch, plain, inc, lits, sel=None):
    """A replica-first plain version replica by replica (its int64
    temporaries grow with R x rows x B x W), concatenated."""
    D = lits.shape[0]
    outs = [plain(inc[r:r + 1], lits[r % D:r % D + 1]) if sel is None
            else plain(inc[r:r + 1], sel[r:r + 1], lits[r % D:r % D + 1])
            for r in range(inc.shape[0])]
    return torch.cat(outs)


def phase_b1_probe(torch, np) -> dict:
    """The rates of the two ways to count sum_w popcount(inc & ~lit) on
    this card, from ``csrc/probe.cu``: loops of independent ``mma.sync``
    m16n8k256 .b1 AND-popcount products (16 warps a block) and of
    ``__popc(a & ~b)`` (512 threads a block), one block an SM. Each block
    reads its SM's clock around its loop; a rate is an SM's bit
    operations (one AND-popcount of one bit pair) over its clock span,
    the median over the SMs. Returns {kind: bit operations a clock an
    SM} and the peak bit operations a second of each (times the SM count
    and the maximum SM clock, as the ``__popc`` table rate is)."""
    from repro_torch.kernels import _build

    lib = _build.library("probe")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 17)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, 256, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    out = {"sms": sms, "max_sm_mhz": mhz}
    for kind, fn, iters in (("b1_mma", lib.b1_mma_probe, 2048),
                            ("popc", lib.popc_probe, 2048)):
        threads = 512
        sink = torch.empty(sms * threads, dtype=torch.int32, device=dev)
        stamp = torch.zeros((sms, 4), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        for n in (16, iters):        # a short warm launch, then the run
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _build.check(fn(words.data_ptr(), sms, threads, n,
                            sink.data_ptr(), stamp.data_ptr(), stream),
                         f"{kind} probe")
            b.record()
            b.synchronize()
        st = stamp.cpu().numpy()
        per_sm = {}
        for t0, t1, sm, bits in st:
            lo, hi, n_bits = per_sm.get(int(sm), (t0, t1, 0))
            per_sm[int(sm)] = (min(lo, t0), max(hi, t1), n_bits + bits)
        rates = sorted(n_bits / (hi - lo) for lo, hi, n_bits in
                       per_sm.values())
        rate = float(rates[len(rates) // 2])
        wall = float(st[:, 3].sum()) / (a.elapsed_time(b) * 1e-3)
        out[kind] = rate
        out[kind + "_peak_per_s"] = rate * sms * mhz * 1e6
        print(f"b1_probe {kind}: {rate:.1f} bit operations a clock an SM "
              f"(median of {len(per_sm)} SMs, {sms} blocks, min "
              f"{rates[0]:.1f}, max {rates[-1]:.1f}); "
              f"{wall / 1e12:.2f} T bit operations/s by CUDA events; peak "
              f"{out[kind + '_peak_per_s'] / 1e12:.2f} T/s at {mhz:.0f} MHz",
              flush=True)
    out["faster"] = "b1_mma" if out["b1_mma"] > out["popc"] else "popc"
    print(f"b1_probe: the b1 MMA counts {out['b1_mma'] / out['popc']:.2f}x "
          f"the bits a clock of __popc; faster: {out['faster']}", flush=True)
    return out


def phase_parity(torch, np, ce, fb):
    """K1/K2/K8 against their plain versions; returns the kernel records
    at the main path's full-width shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    err = {"clause_counts": 0, "clause_counts_batch": 0, "feedback_plane": 0}

    def rand_bool(shape, p):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    def max_err(got, want):
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    for cj, L in SHAPES + [(12, L) for L in EDGE_L]:
        inc = rand_bool((cj, L), 0.05)
        batches = (1, 128, 1024) if (cj, L) == FULL else (1, 7)
        for B in batches:
            lits = rand_bool((B, L), 0.5)
            got = ce.clause_counts_batch(inc, lits)
            want = ce.clause_counts_batch_plain(inc, lits)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            err["clause_counts_batch"] = max(err["clause_counts_batch"],
                                             max_err(got, want))
            print(f"parity K2 clause_counts_batch CJ={cj} L={L} B={B} "
                  f"equal={ok}", flush=True)
            check(ok, f"K2 differs from its plain version at {cj, L, B}")
        # K1 and K8 on each placement of the operands (PLACEMENTS).
        for what, view, lview in placements(torch):
            got = ce.clause_counts(view(inc), lview(lits[0]))
            want = ce.clause_counts_plain(inc, lits[0])
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            err["clause_counts"] = max(err["clause_counts"],
                                       max_err(got, want))
            print(f"parity K1 clause_counts CJ={cj} L={L} {what} "
                  f"equal={ok}", flush=True)
            check(ok, f"K1 differs from its plain version at {cj, L, what}")
            for dtype, n_states in ((torch.int8, 63), (torch.int16, 5000)):
                ta = torch.from_numpy(rng.integers(
                    1, 2 * n_states + 1, (cj, L))).to(dtype).to(dev)
                ctl = [rand_bool((cj,), 0.5) for _ in range(3)]
                u = torch.from_numpy(rng.random((cj, L),
                                                dtype=np.float32)).to(dev)
                args = (ta, lits[0], *ctl, u, 0.75, 1.0 / 3.0)
                got = fb.feedback_plane(
                    view(ta), lview(lits[0]), *map(view, ctl), view(u),
                    0.75, 1.0 / 3.0, n_states=n_states)
                want = fb.feedback_plane_plain(*args, n_states=n_states)
                torch.cuda.synchronize()
                ok = torch.equal(got, want)
                err["feedback_plane"] = max(err["feedback_plane"],
                                            max_err([got], [want]))
                print(f"parity K8 feedback_plane CJ={cj} L={L} {dtype} "
                      f"{what} equal={ok}", flush=True)
                check(ok, f"K8 differs from its plain version at "
                          f"{cj, L, dtype, what}")

    # K2's tensor-core body at its edges, one launch a call, against the
    # plain version on the same operands as bools (any nonzero byte is 1).
    def hold_k2(inc, lits, view, lview, what):
        before = ce.clause_counts_batch.launches
        got = ce.clause_counts_batch(view(inc), lview(lits))
        check(ce.clause_counts_batch.launches == before + 1,
              f"K2 launched other than once at {what}")
        want = ce.clause_counts_batch_plain(inc.to(torch.bool),
                                            lits.to(torch.bool))
        torch.cuda.synchronize()
        err["clause_counts_batch"] = max(err["clause_counts_batch"],
                                         max_err(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K2 differs from its plain version at CJ=70 {what}")

    byte_edges(torch, np, rng, dev, hold_k2, (70,), ())
    print(f"parity K2 clause_counts_batch CJ=70 L {BYTE_L} x {BYTE_KINDS} "
          f"x B {BYTE_B} x {[p[0] for p in PLACEMENTS]} equal=True",
          flush=True)

    # Times at the main path's shapes: K1 and K8 once per training step,
    # K2 at the 1024-row serve.
    cj, L = FULL
    B = 1024
    inc = rand_bool((cj, L), 0.05)
    lits = rand_bool((B, L), 0.5)
    ta = torch.from_numpy(rng.integers(1, 127, (cj, L))).to(torch.int8).to(dev)
    ctl = [rand_bool((cj,), 0.5) for _ in range(3)]
    u = torch.from_numpy(rng.random((cj, L), dtype=np.float32)).to(dev)
    inc_f = inc.to(torch.float32)
    rhs1 = torch.stack([1.0 - lits[0].float(), torch.ones(L, device=dev)], 1)
    rhsb = torch.cat([(1.0 - lits.float()).T,
                      torch.ones(L, 1, device=dev)], 1)
    fb_args = (ta, lits[0], *ctl, u, 0.75, 1.0 / 3.0)
    recs = []
    for name, src, replaces, kern, plain, lib, nbytes, ops, rate in (
        ("clause_counts", "clause_eval.cu",
         "src/repro/kernels/clause_eval.py:78",
         lambda: ce.clause_counts(inc, lits[0]),
         lambda: ce.clause_counts_plain(inc, lits[0]),
         lambda: inc_f @ rhs1,
         cj * L + L + 2 * cj * 4, 2.0 * cj * L * 2, INT8_OPS_PER_S),
        ("clause_counts_batch", "clause_eval.cu",
         "src/repro/kernels/clause_eval.py:130",
         lambda: ce.clause_counts_batch(inc, lits),
         lambda: ce.clause_counts_batch_plain(inc, lits),
         lambda: inc_f @ rhsb,
         cj * L + B * L + cj * B * 4 + cj * 4, 2.0 * cj * L * (B + 1),
         INT8_OPS_PER_S),
        ("feedback_plane", "feedback.cu",
         "src/repro/kernels/feedback.py:91",
         lambda: fb.feedback_plane(*fb_args, n_states=63),
         lambda: fb.feedback_plane_plain(*fb_args, n_states=63),
         None,
         2 * cj * L + 4 * cj * L + L + 3 * cj, 10.0 * cj * L, F32_OPS_PER_S),
    ):
        b_ms, b_by = bound(nbytes, ops, rate)
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else time_ms(torch, lib),
        }
        print(f"time {name}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms, library {rec['library_ms']} ms, "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)
        recs.append(rec)
    # K2's second yardstick: the same int8 contraction as one
    # torch._int_mm, include [CJ, L] x [L, B + 8] (the zero-literal
    # columns, a ones column and 7 zero columns: a multiple of 8)
    rhs = torch.cat([(~lits).to(torch.int8),
                     torch.ones((1, L), dtype=torch.int8, device=dev),
                     torch.zeros((7, L), dtype=torch.int8, device=dev)])
    ms, why = int_mm_ms(torch, inc.to(torch.int8), rhs.T)
    recs[1]["int_mm_library_ms"] = ms
    if why:
        recs[1]["int_mm_note"] = f"torch._int_mm did not run: {why}"
    print(f"time clause_counts_batch: torch._int_mm of the same int8 "
          f"contraction {ms if why else f'{ms:.5f}'} ms"
          f"{f' (did not run: {why})' if why else ''}", flush=True)
    return recs


def phase_parity_replicated(torch, np, ce, fb):
    """K3/K4/K9 against their plain versions; returns the kernel records
    at the f = 784 system's shapes (R = D = 8, K4 at B = 150)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    err = {"clause_counts_replicated": 0,
           "clause_counts_batch_replicated": 0,
           "feedback_plane_replicated": 0}

    def rand_bool(shape, p):
        return torch.from_numpy(rng.random(shape) < p).to(dev)

    def max_err(got, want):
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err[name] = max(err[name], max_err(got, want))
        print(f"parity {name} {what} equal={ok}", flush=True)
        check(ok, f"{name} differs from its plain version at {what}")

    for R, D, cj, L in REP_SHAPES + [(4, 2, 12, L) for L in EDGE_L]:
        inc = rand_bool((R, cj, L), 0.05)
        for B in (1, 7, B_ANALYSIS):
            lits = rand_bool((D, B, L), 0.5)
            hold("clause_counts_batch_replicated",
                 ce.clause_counts_batch_replicated(inc, lits),
                 ce.clause_counts_batch_replicated_plain(inc, lits),
                 f"R={R} D={D} CJ={cj} L={L} B={B}")
        lit = lits[:, 0].contiguous()
        # K3 and K9 on each placement of the operands (PLACEMENTS).
        for what, view, lview in placements(torch):
            hold("clause_counts_replicated",
                 ce.clause_counts_replicated(view(inc), lview(lit)),
                 ce.clause_counts_replicated_plain(inc, lit),
                 f"R={R} D={D} CJ={cj} L={L} {what}")
            for dtype, n_states in ((torch.int8, 63), (torch.int16, 5000)):
                ta = torch.from_numpy(rng.integers(
                    1, 2 * n_states + 1, (R, cj, L))).to(dtype).to(dev)
                ctl = [rand_bool((R, cj), 0.5) for _ in range(3)]
                u = torch.from_numpy(rng.random((D, cj, L),
                                                dtype=np.float32)).to(dev)
                ps, pe = (torch.from_numpy(rng.random(R, dtype=np.float32))
                          .to(dev) for _ in range(2))
                args = (ta, lit, *ctl, u, ps, pe)
                hold("feedback_plane_replicated",
                     [fb.feedback_plane_replicated(
                         view(ta), lview(lit), *map(view, ctl), view(u),
                         view(ps), view(pe), n_states=n_states)],
                     [fb.feedback_plane_replicated_plain(
                         *args, n_states=n_states)],
                     f"R={R} D={D} CJ={cj} L={L} {dtype} {what}")

    # K4's tensor-core body at its edges (R = 4 banks on D = 2 streams),
    # one launch a call, against the plain version on bool operands.
    def hold_k4(inc, lits, view, lview, what):
        before = ce.clause_counts_batch_replicated.launches
        got = ce.clause_counts_batch_replicated(view(inc), lview(lits))
        check(ce.clause_counts_batch_replicated.launches == before + 1,
              f"K4 launched other than once at {what}")
        want = ce.clause_counts_batch_replicated_plain(inc.to(torch.bool),
                                                       lits.to(torch.bool))
        torch.cuda.synchronize()
        err["clause_counts_batch_replicated"] = max(
            err["clause_counts_batch_replicated"], max_err(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K4 differs from its plain version at R=4 D=2 CJ=70 {what}")

    byte_edges(torch, np, rng, dev, hold_k4, (4, 70), (2,))
    byte_edges(torch, np, rng, dev, hold_k4, (BIG_R, BIG_ROWS), (2,),
               (BIG_B,))
    print(f"parity clause_counts_batch_replicated R=4 D=2 CJ=70 L {BYTE_L} "
          f"x {BYTE_KINDS} x B {BYTE_B} x {[p[0] for p in PLACEMENTS]}, and "
          f"R={BIG_R} CJ={BIG_ROWS} B={BIG_B} (128 x 128 tiles) equal=True",
          flush=True)

    # Times at the f = 784 system's shapes: K3 and K9 once per training
    # step, K4 once per cycle over the three concatenated sets.
    R, D, cj, L = WIDE
    B = B_ANALYSIS
    inc = rand_bool((R, cj, L), 0.05)
    lits = rand_bool((D, B, L), 0.5)
    ta = torch.from_numpy(rng.integers(1, 127, (R, cj, L))).to(
        torch.int8).to(dev)
    ctl = [rand_bool((R, cj), 0.5) for _ in range(3)]
    u = torch.from_numpy(rng.random((D, cj, L), dtype=np.float32)).to(dev)
    ps = torch.full((R,), 0.75, device=dev)
    pe = torch.full((R,), 1.0 / 3.0, device=dev)
    # the datapoint rows [D, L], contiguous as the engine passes them (a
    # strided lits[:, 0] would add a copy kernel to every timed call)
    lit = lits[:, 0].contiguous()
    fb_args = (ta, lit, *ctl, u, ps, pe)
    rows = torch.arange(R, device=dev) % D
    inc_f = inc.to(torch.float32)
    rhs1 = torch.stack([1.0 - lit.float(),
                        torch.ones(D, L, device=dev)], -1)[rows]
    rhsb = torch.cat([(1.0 - lits.float()).transpose(1, 2),
                      torch.ones(D, L, 1, device=dev)], -1)[rows]
    recs = []
    for name, replaces, kern, plain, lib, nbytes, ops, rate in (
        ("clause_counts_replicated", "src/repro/kernels/clause_eval.py:193",
         lambda: ce.clause_counts_replicated(inc, lit),
         lambda: ce.clause_counts_replicated_plain(inc, lit),
         lambda: torch.bmm(inc_f, rhs1),
         R * cj * L + D * L + 2 * R * cj * 4, 2.0 * R * cj * L * 2,
         INT8_OPS_PER_S),
        ("clause_counts_batch_replicated",
         "src/repro/kernels/clause_eval.py:254",
         lambda: ce.clause_counts_batch_replicated(inc, lits),
         lambda: ce.clause_counts_batch_replicated_plain(inc, lits),
         lambda: torch.bmm(inc_f, rhsb),
         R * cj * L + D * B * L + R * cj * B * 4 + R * cj * 4,
         2.0 * R * cj * L * (B + 1), INT8_OPS_PER_S),
        ("feedback_plane_replicated", "src/repro/kernels/feedback.py:145",
         lambda: fb.feedback_plane_replicated(*fb_args, n_states=63),
         lambda: fb.feedback_plane_replicated_plain(*fb_args, n_states=63),
         None,
         2 * R * cj * L + 4 * D * cj * L + D * L + 3 * R * cj + 8 * R,
         10.0 * R * cj * L, F32_OPS_PER_S),
    ):
        src = "feedback.cu" if name.startswith("feedback") else \
            "clause_eval.cu"
        b_ms, b_by = bound(nbytes, ops, rate)
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else time_ms(torch, lib),
        }
        print(f"time {name} (R={R} D={D} CJ={cj} L={L}"
              f"{f' B={B}' if 'batch' in name else ''}): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, library "
              f"{rec['library_ms']} ms, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
        recs.append(rec)

    # K9 where replicas share data streams (D < R: a grid over orderings),
    # so a u row is read by R / D replicas: R = 16, D = 4.
    R, D = 16, 4
    ta = torch.from_numpy(rng.integers(1, 127, (R, cj, L))).to(
        torch.int8).to(dev)
    ctl = [rand_bool((R, cj), 0.5) for _ in range(3)]
    u = torch.from_numpy(rng.random((D, cj, L), dtype=np.float32)).to(dev)
    ps = torch.full((R,), 0.75, device=dev)
    pe = torch.full((R,), 1.0 / 3.0, device=dev)
    lit = rand_bool((D, L), 0.5)
    ms = time_ms(torch, lambda: fb.feedback_plane_replicated(
        ta, lit, *ctl, u, ps, pe, n_states=63))
    b_ms, _ = bound(2 * R * cj * L + 4 * D * cj * L + D * L + 3 * R * cj
                    + 8 * R, 10.0 * R * cj * L, F32_OPS_PER_S)
    recs[-1].update(ms_r16_d4=ms, bound_ms_r16_d4=b_ms)
    print(f"time feedback_plane_replicated (R={R} D={D} CJ={cj} L={L}): "
          f"kernel {ms:.5f} ms, bound {b_ms:.5f} ms (bytes)", flush=True)
    return recs


def phase_parity_packed(torch, np, ce, probe, word_err):
    """K5/K6 against their plain versions and against K2/K4 on the same
    problem unpacked (packed == unpacked), with an all-empty and an
    all-include clause row in every bank; returns the kernel records at
    the main path's shapes (K5: the 1024-row serve of one machine; K6: a
    K = 16 fleet's three-set-sized batch, B = 150, D = 1), bound by their
    bytes or their bit operations at the b1 product's peak that
    ``probe`` (phase b1_probe) measured. ``word_err``: the largest errors
    of phase parity_words."""
    from repro_torch.kernels import packing

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 13)
    err = {k: word_err[k] for k in ("clause_counts_batch_packed",
                                    "clause_counts_batch_replicated_packed")}
    n_checks = {k: 0 for k in err}

    def operands(lead_i, lead_l, cj, f, B):
        inc = torch.from_numpy(rng.random(lead_i + (cj, 2 * f)) < 0.05).to(dev)
        inc[..., 0, :] = False                  # an empty clause row
        inc[..., -1, :] = True                  # an all-include row
        x = torch.from_numpy(rng.random(lead_l + (B, f)) < 0.5).to(dev)
        return (packing.pack_include(inc, f), packing.pack_literals(x), inc,
                torch.cat([x, ~x], -1))

    def hold(name, got, plain, unpacked, what):
        torch.cuda.synchronize()
        ok = torch.equal(got, plain) and torch.equal(got, unpacked)
        err[name] = max(err[name], *(int((got.long() - w.long()).abs().max())
                                     for w in (plain, unpacked)))
        n_checks[name] += 1
        check(ok, f"{name} differs from its plain version or the unpacked "
                  f"kernel at {what}")

    for f in PACKED_F:
        for cj in PACKED_CJ:
            for B in PACKED_B:
                inc_w, lit_w, inc, lits = operands((), (), cj, f, B)
                hold("clause_counts_batch_packed",
                     ce.clause_counts_batch_packed(inc_w, lit_w),
                     ce.clause_counts_batch_packed_plain(inc_w, lit_w),
                     ce.clause_counts_batch(inc, lits)[0],
                     f"f={f} CJ={cj} B={B}")
        print(f"parity K5 clause_counts_batch_packed f={f} "
              f"W={packing.lit_words(f)} CJ {PACKED_CJ} x B {PACKED_B} "
              "equal=True", flush=True)
    for R, D in PACKED_RD:
        for B in (1, 7, 150):
            inc_w, lit_w, inc, lits = operands((R,), (D,), 640, 784, B)
            hold("clause_counts_batch_replicated_packed",
                 ce.clause_counts_batch_replicated_packed(inc_w, lit_w),
                 ce.clause_counts_batch_replicated_packed_plain(inc_w, lit_w),
                 ce.clause_counts_batch_replicated(inc, lits)[0],
                 f"R={R} D={D} B={B}")
        print(f"parity K6 clause_counts_batch_replicated_packed R={R} D={D} "
              "CJ=640 W=50 B (1, 7, 150) equal=True", flush=True)
    print(f"parity packed checks: {json.dumps(n_checks)}", flush=True)

    rate = probe["b1_mma_peak_per_s"]
    recs = []
    for name, replaces, rep, (R, D, B) in (
        ("clause_counts_batch_packed", "src/repro/kernels/clause_eval.py:391",
         False, (1, 1, 1024)),
        ("clause_counts_batch_replicated_packed",
         "src/repro/kernels/clause_eval.py:454", True,
         (FLEET_K, 1, B_ANALYSIS)),
    ):
        inc_w, lit_w, inc, lits = operands((R,) if rep else (),
                                           (D,) if rep else (), 640, 784, B)
        kern, plain, unpacked = (
            (lambda: ce.clause_counts_batch_replicated_packed(inc_w, lit_w),
             lambda: ce.clause_counts_batch_replicated_packed_plain(
                 inc_w, lit_w),
             lambda: ce.clause_counts_batch_replicated(inc, lits))
            if rep else
            (lambda: ce.clause_counts_batch_packed(inc_w, lit_w),
             lambda: ce.clause_counts_batch_packed_plain(inc_w, lit_w),
             lambda: ce.clause_counts_batch(inc, lits)))
        cj, W = inc_w.shape[-2:]
        nbytes = 4 * (R * cj * W + D * B * W + R * cj * B)
        bits = 32 * R * cj * B * W
        b_ms, b_by = bound(nbytes, bits, rate)
        rec = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/clause_eval.cu",
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": time_ms(torch, kern),
            # the plain SWAR popcount holds ~3 GB of int64 temporaries a
            # call at these shapes: fewer calls per captured graph
            "plain_ms": time_ms(torch, plain, inner=4),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        un_ms = time_ms(torch, unpacked)
        print(f"time {name} (R={R} D={D} CJ={cj} W={W} B={B}): kernel "
              f"{rec['ms']:.5f} ms, plain {rec['plain_ms']:.5f} ms, unpacked "
              f"{'K4' if rep else 'K2'} on the same problem {un_ms:.5f} "
              f"ms, library None, bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
              f"{bits} bit operations at the measured b1 peak "
              f"{rate:.4g}/s)", flush=True)
        recs.append(rec)
    return recs


def phase_parity_words(torch, np, ce):
    """The word body at its edges (WORD_W x WORD_KINDS x BYTE_B x
    WORD_PLACEMENTS): K6 on R = 4 banks of 70 rows (two row tiles) on D =
    2 streams and K5 on replica 0; K7 on words, replica-first (R = 4
    banks of 3 classes x 40 clauses on D = 2 streams) and K = 1, taking
    int32 and int64 selections in turn (permutation prefixes at M = 1, 20,
    40 and ids with repeats at M = 20, each holding ids 0 and J - 1), also
    against gather + K6 (K = 1: gather + K5); then the same on the
    128 x 128 tiles (R = 16 banks of 300 rows, B = 1000). Each call is one
    launch and equal to the plain version with ``torch.equal``. Returns
    the largest error of each."""
    from repro_torch.kernels.ref import gather_include

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 18)
    names = ("clause_counts_batch_packed",
             "clause_counts_batch_replicated_packed",
             "clause_counts_batch_pruned_packed",
             "clause_counts_batch_pruned_replicated_packed")
    err = dict.fromkeys(names, 0)
    n_checks = dict.fromkeys(names, 0)

    def hold(name, got, want, what):
        err[name] = max(err[name], int((got.long() - want.long()).abs().max()))
        n_checks[name] += 1
        check(torch.equal(got, want), f"{name} differs from its plain "
              f"version at {what}")

    def launched(fns, before, what):
        check([f.launches for f in fns] == [n + 1 for n in before],
              f"{[f.__name__ for f in fns]} launched other than once a call "
              f"at {what}")

    k5, k6 = ce.clause_counts_batch_packed, \
        ce.clause_counts_batch_replicated_packed
    k7, k7r = ce.clause_counts_batch_pruned_packed, \
        ce.clause_counts_batch_pruned_replicated_packed

    def hold_k56(inc, lits, placed, what):
        want6 = by_replica(torch, ce.clause_counts_batch_replicated_packed_plain,
                           inc, lits)
        want5 = ce.clause_counts_batch_packed_plain(inc[0], lits[0])
        for where, view, lview in placed:
            before = [k5.launches, k6.launches]
            got6 = k6(view(inc), lview(lits))
            got5 = k5(view(inc)[0], lview(lits)[0])
            launched((k5, k6), before, f"{what} {where}")
            torch.cuda.synchronize()
            hold(names[1], got6, want6, f"R={inc.shape[0]} {what} {where}")
            hold(names[0], got5, want5, f"{what} {where}")

    def selections(R, C, J, Ms):
        """int32 and int64 [R, C, M] on the card: permutation prefixes at
        each M and ids with repeats at the middle one, each with ids 0 and
        J - 1."""
        out = [np.stack([np.stack([rng.permutation(J)[:M] for _ in range(C)])
                         for _ in range(R)]) for M in Ms]
        rep = rng.integers(0, J, (R, C, Ms[len(Ms) // 2]))
        rep[..., -1] = rep[..., 0]
        out.append(rep)
        for a in out:
            a[:, 0, 0] = 0
            a[:, -1, -1] = J - 1
        return [torch.from_numpy(a.astype(dt)).to(dev) for a in out
                for dt in (np.int32, np.int64)]

    sels, turn = [], [0]

    def hold_k7(inc, lits, placed, what):
        R = inc.shape[0]
        for where, view, lview in placed:
            sel = sels[turn[0] % len(sels)]
            turn[0] += 1
            w = f"R={R} M={sel.shape[-1]} {sel.dtype} {what} {where}"
            before = [k7.launches, k7r.launches]
            got = k7r(view(inc), sel, lview(lits))
            one = k7(view(inc)[0], sel[0], lview(lits)[0])
            launched((k7, k7r), before, w)
            want = by_replica(
                torch, ce.clause_counts_batch_pruned_replicated_packed_plain,
                inc, lits, sel)
            W = inc.shape[-1]
            gath = k6(gather_include(inc, sel).reshape(R, -1, W), lits)
            gath1 = k5(gather_include(inc[0], sel[0]).reshape(-1, W), lits[0])
            torch.cuda.synchronize()
            hold(names[3], got, want, w)
            hold(names[3], got, gath, w + " (gather + K6)")
            hold(names[2], one, want[0], w)
            hold(names[2], one, gath1, w + " (gather + K5)")

    word_edges(torch, np, rng, dev, hold_k56, (4, 70), (2,))
    print(f"parity K5/K6 words R=4 D=2 CJ=70 W {WORD_W} x {WORD_KINDS} x "
          f"B {BYTE_B} x {[p[0] for p in WORD_PLACEMENTS]} equal=True",
          flush=True)
    sels[:] = selections(4, 3, 40, (1, 20, 40))
    word_edges(torch, np, rng, dev, hold_k7, (4, 3, 40), (2,))
    print(f"parity K7 words R=4 D=2 C=3 J=40 W {WORD_W} x {WORD_KINDS} x "
          f"B {BYTE_B} x {[p[0] for p in WORD_PLACEMENTS]}, {len(sels)} "
          "selections in turn equal=True", flush=True)
    # the 128 x 128 tiles
    word_edges(torch, np, rng, dev, hold_k56, (BIG_R, BIG_ROWS), (2,),
               (BIG_B,))
    sels[:] = selections(BIG_R, 3, 120, (BIG_ROWS // 3,))
    word_edges(torch, np, rng, dev, hold_k7, (BIG_R, 3, 120), (2,), (BIG_B,))
    print(f"parity K5/K6/K7 words on the 128 x 128 tiles: R={BIG_R} "
          f"{BIG_ROWS} rows (K7: C=3 J=120 M={BIG_ROWS // 3}) B={BIG_B} "
          "equal=True", flush=True)
    print(f"parity words checks: {json.dumps(n_checks)}", flush=True)
    return err


def run_service(torch, np, cfg, data, on_chunk, packed=False):
    """The main path: offline_train -> submit + tick -> serve. Returns
    the service, its reports, the served predictions and the timings."""
    from repro_torch import random as rnd
    from repro_torch.core import init_state
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs_off, ys_off, xs_on, ys_on, xs_ev, ys_ev, xs_serve = data
    svc = TMService(
        cfg, init_state(cfg, rnd.PRNGKey(SEED, "cuda"), device="cuda"),
        ServiceConfig(replicas=1, buffer_capacity=128, chunk=16, s=2.0, T=32,
                      policy=AdaptPolicy(analyze_every=32), seed=SEED,
                      packed=packed),
        eval_x=xs_ev, eval_y=ys_ev, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = svc.offline_train(xs_off, ys_off, n_epochs=2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for x, y in zip(xs_on, ys_on):
        check(svc.submit(0, x, int(y)), "a submitted row was refused")
    reports = []
    while int(svc.buffered[0]):
        reports.append(svc.tick(on_chunk=on_chunk))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    served = svc.serve(xs_serve)
    t3 = time.perf_counter()
    timing = {"offline_points_per_s": 2 * len(xs_off) / (t1 - t0),
              "drain_points_per_s": len(xs_on) / (t2 - t1),
              "serve_ms": (t3 - t2) * 1e3}
    return svc, base, reports, served, timing


def phase_main(torch, np, ce, fb):
    from repro_torch.configs import tm_mnist
    from repro_torch.data import mnist

    xs, ys = mnist.load(seed=SEED, n_points=296)
    xs_serve, _ = mnist.load(seed=SEED + 1, n_points=1024)
    data = (xs[:100], ys[:100], xs[100:196], ys[100:196], xs[196:],
            ys[196:], xs_serve)
    cfg = tm_mnist.CONFIG.tm
    check(cfg.n_features == 784 and cfg.backend == "auto",
          "the preset is not the full-width machine on backend auto")

    runs = {}
    for name, backend, packed in (("auto", "auto", False), ("ref", "ref", False),
                                  ("packed", "auto", True)):
        chunks = []
        c = dataclasses.replace(cfg, backend=backend)
        if backend == "auto":
            zero_counters(ce, fb)
        runs[name] = run_service(torch, np, c, data, chunks.append,
                                 packed) + (chunks,)
        if name == "auto":
            launches = {"clause_counts": ce.clause_counts.launches,
                        "clause_counts_batch": ce.clause_counts_batch.launches,
                        "feedback_plane": fb.feedback_plane.launches}
        if name == "packed":
            launches["clause_counts_batch_packed"] = \
                ce.clause_counts_batch_packed.launches
            n_k5 = ce.clause_counts_batch_packed.launches
            svc_p, _, rep_p, _, _, chunks_p = runs[name]
            want_k5 = len(svc_p.history) + len(chunks_p) + 1
            print(f"main packed K=1 launches: K5 {n_k5} (from the code: "
                  f"{want_k5}: analyses + monitored chunks + 1 serve), K2 "
                  f"{ce.clause_counts_batch.launches}", flush=True)
            check(n_k5 == want_k5 and ce.clause_counts_batch.launches == 0,
                  "the packed K = 1 service did not serve, analyze and "
                  "monitor through K5 alone")
    a, r, p = runs["auto"], runs["ref"], runs["packed"]
    svc_a, base_a, rep_a, served_a, timing, chunks_a = a
    svc_r, base_r, rep_r, served_r, _, chunks_r = r

    def same(x, y):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        return x.shape == y.shape and np.array_equal(x, y)

    check(torch.equal(svc_a.ss.tm.ta_state, svc_r.ss.tm.ta_state),
          "TA banks differ between the kernels and the plain versions")
    check(same(svc_a.rng_keys, svc_r.rng_keys), "RNG keys differ")
    check(same(base_a, base_r), "offline accuracies differ")
    check(len(rep_a) == len(rep_r), "tick counts differ")
    for x, y in zip(rep_a, rep_r):
        check(same(x.trained, y.trained) and same(x.rolled_back, y.rolled_back)
              and (x.accuracy is None) == (y.accuracy is None)
              and (x.accuracy is None or same(x.accuracy, y.accuracy)),
              "tick reports differ")
    check(len(svc_a.history) == len(svc_r.history)
          and all(same(s1, s2) and same(a1, a2) for (s1, a1), (s2, a2)
                  in zip(svc_a.history, svc_r.history)),
          "analysis histories differ")
    check(len(chunks_a) == len(chunks_r) and all(
        same(getattr(x, f).cpu(), getattr(y, f).cpu())
        for x, y in zip(chunks_a, chunks_r) for f in x._fields),
        "chunk monitoring differs")
    check(same(served_a, served_r), "served predictions differ")
    # The packed datapath: ring rows and the eval set as words, K5 for
    # every batch pass; bit for bit the unpacked run.
    svc_p, base_p, rep_p, served_p, timing_p, chunks_p = p
    check(svc_p.ss.buf.data_x.dtype == torch.int32
          and svc_p.ss.buf.data_x.shape[-1] == 25, "packed ring is not words")
    check(torch.equal(svc_a.ss.tm.ta_state, svc_p.ss.tm.ta_state)
          and same(svc_a.rng_keys, svc_p.rng_keys) and same(base_a, base_p)
          and same(served_a, served_p) and len(rep_a) == len(rep_p)
          and all(same(x.trained, y.trained)
                  and (x.accuracy is None) == (y.accuracy is None)
                  and (x.accuracy is None or same(x.accuracy, y.accuracy))
                  for x, y in zip(rep_a, rep_p))
          and len(chunks_a) == len(chunks_p) and all(
              same(getattr(x, f).cpu(), getattr(y, f).cpu())
              for x, y in zip(chunks_a, chunks_p) for f in x._fields),
          "the packed K = 1 service differs from the unpacked one")

    accs = [float(acc[0]) for _, acc in svc_a.history]
    check(served_a.shape == (1, 1024) and served_a.min() >= 0
          and served_a.max() < cfg.max_classes, "served predictions malformed")
    check(all(np.isfinite(acc) and 0.0 <= acc <= 1.0 for acc in accs),
          "accuracies not in [0, 1]")
    check(int(svc_a.steps[0]) == 96 and int(svc_a.buffered[0]) == 0,
          "the drain did not consume every submitted row")
    check(len(chunks_a) > 0, "the monitor saw no chunk")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    print(f"main TMService f=784 K=1: offline acc {float(base_a[0]):.4f}, "
          f"analysis accs {[round(x, 4) for x in accs]}, "
          f"ticks {len(rep_a)}, auto == ref bitwise: True", flush=True)
    print(f"main throughput: offline_train "
          f"{timing['offline_points_per_s']:.2f} points/s, drain "
          f"{timing['drain_points_per_s']:.2f} points/s, serve(1024) "
          f"{timing['serve_ms']:.3f} ms", flush=True)
    print(f"main packed throughput: offline_train "
          f"{timing_p['offline_points_per_s']:.2f} points/s, drain "
          f"{timing_p['drain_points_per_s']:.2f} points/s, serve(1024) "
          f"{timing_p['serve_ms']:.3f} ms; packed == unpacked bitwise: True",
          flush=True)
    print(f"main launches: {json.dumps(launches)}", flush=True)
    return launches


def run_fleet(torch, np, cfg, data, packed, on_chunk):
    """The fleet's main path: a K = 16 TMService with a 4 x 4 grid of
    per-replica (s, T) ports: offline_train (1 epoch), submit_rows of each
    member's own stream then tick until drained, and a shared (D = 1) and
    a per-member serve. Returns the service, its outputs and the timings."""
    from repro_torch import random as rnd
    from repro_torch.core import init_state
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    xs_off, ys_off, xs_on, ys_on, xs_ev, ys_ev, xs_serve, xs_member = data
    K, n_on = xs_on.shape[:2]
    svc = TMService(
        cfg, init_state(cfg, rnd.PRNGKey(SEED, "cuda"), device="cuda"),
        ServiceConfig(replicas=K, packed=packed, buffer_capacity=64, chunk=16,
                      s=[s for s in FLEET_S for _ in FLEET_T],
                      T=[t for _ in FLEET_S for t in FLEET_T],
                      policy=AdaptPolicy(analyze_every=32), seed=SEED),
        eval_x=xs_ev, eval_y=ys_ev, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = svc.offline_train(xs_off, ys_off, n_epochs=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(n_on):
        check(svc.submit_rows(xs_on[:, i], ys_on[:, i]).all(),
              "a fleet row was refused")
    svc.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reports = []
    while svc.buffered.any():
        reports.append(svc.tick(on_chunk=on_chunk))
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    shared = svc.serve(xs_serve)
    t4 = time.perf_counter()
    member = svc.serve(xs_member)
    t5 = time.perf_counter()
    timing = {"offline_points_per_s": K * len(xs_off) / (t1 - t0),
              "ingress_rows_per_s": K * n_on / (t2 - t1),
              "drain_points_per_s": K * n_on / (t3 - t2),
              "serve_ms": (t4 - t3) * 1e3, "serve_member_ms": (t5 - t4) * 1e3}
    return svc, base, reports, shared, member, timing


def phase_fleet(torch, np, ce, fb):
    """The K = 16 packed fleet at the full MNIST width (f = 784), through
    the kernels (backend "auto"), then backend "ref", then unpacked: all
    three bitwise equal. Returns the K6 launches of the packed "auto"
    run, which must match the counts the code implies."""
    from repro_torch.configs import tm_mnist
    from repro_torch.data import mnist
    from repro_torch.kernels import packing

    K = FLEET_K
    xs, ys = mnist.load(seed=SEED + 5, n_points=200 + K * 64)
    xs_serve, _ = mnist.load(seed=SEED + 6, n_points=1024)
    on = 200 + np.arange(K * 64).reshape(K, 64)     # each member's stream
    data = (xs[:100], ys[:100], xs[on], ys[on], xs[100:200], ys[100:200],
            xs_serve, xs[on])
    cfg = tm_mnist.CONFIG.tm
    check(cfg.n_features == 784 and cfg.max_classes * cfg.max_clauses == 640,
          "the preset is not the full-width machine")
    runs = {}
    for name, backend, packed in (("auto", "auto", True), ("ref", "ref", True),
                                  ("unpacked", "auto", False)):
        chunks = []
        zero_counters(ce, fb)
        out = run_fleet(torch, np, dataclasses.replace(cfg, backend=backend),
                        data, packed, chunks.append)
        runs[name] = out + (chunks, counters(ce, fb))
        torch.cuda.synchronize()
    svc, base, reps, shared, member, timing, chunks, launched = runs["auto"]

    def same(x, y):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        return x.shape == y.shape and np.array_equal(x, y)

    for name in ("ref", "unpacked"):
        o, ob, orep, osh, omem, _, och, _ = runs[name]
        ring, oring = svc.ss.buf, o.ss.buf
        rows = (oring.data_x if name == "ref"
                else packing.pack_bits(oring.data_x))
        check(torch.equal(svc.ss.tm.ta_state, o.ss.tm.ta_state)
              and torch.equal(ring.data_x, rows)
              and all(torch.equal(getattr(ring, f), getattr(oring, f))
                      for f in ("data_y", "head", "size"))
              and same(svc.rng_keys, o.rng_keys) and same(svc.steps, o.steps)
              and same(base, ob) and same(shared, osh) and same(member, omem)
              and len(reps) == len(orep) and all(
                  same(x.trained, y.trained) and same(x.rolled_back,
                                                      y.rolled_back)
                  and (x.accuracy is None) == (y.accuracy is None)
                  and (x.accuracy is None or same(x.accuracy, y.accuracy))
                  for x, y in zip(reps, orep))
              and len(svc.history) == len(o.history) and all(
                  same(s1, s2) and same(a1, a2) for (s1, a1), (s2, a2)
                  in zip(svc.history, o.history))
              and len(chunks) == len(och) and all(
                  same(getattr(x, f).cpu(), getattr(y, f).cpu())
                  for x, y in zip(chunks, och) for f in x._fields),
              f"fleet: the packed 'auto' run differs from the {name} run")
    check(svc.ss.buf.data_x.dtype == torch.int32, "fleet rings not packed")
    check(shared.shape == (K, 1024) and member.shape == (K, 64)
          and shared.min() >= 0 and shared.max() < cfg.max_classes,
          "fleet predictions malformed")
    accs = np.stack([a for _, a in svc.history])
    check(np.isfinite(accs).all() and accs.min() >= 0 and accs.max() <= 1,
          "fleet accuracies malformed")
    check(all(int(x) == 64 for x in svc.steps) and not svc.buffered.any(),
          "the fleet did not drain every submitted row")
    # The counts the code implies: K3 + K9 per offline step (100) and per
    # drain step (4 chunks x 16); K6 per analysis, monitored chunk and
    # serve; nothing through the single-machine or unpacked kernels.
    steps = 100 + len(chunks) * 16
    want = {k: 0 for k in launched}
    want.update(clause_counts_replicated=steps, feedback_plane_replicated=steps,
                clause_counts_batch_replicated_packed=(
                    len(svc.history) + len(chunks) + 2))
    print(f"fleet launches (auto, packed): {json.dumps(launched)}, from the "
          f"code: {json.dumps(want)}; unpacked run: "
          f"{json.dumps(runs['unpacked'][-1])}", flush=True)
    check(launched == want, "fleet: kernel launches differ from the counts "
          "the code implies")
    print(f"fleet K={K} f={cfg.n_features} packed: offline acc "
          f"{np.round(base, 4).tolist()}"
          f", final acc {np.round(accs[-1], 4).tolist()}, rollbacks "
          f"{svc.rollbacks.tolist()}, ticks {len(reps)}; auto == ref == "
          "unpacked bitwise: True", flush=True)
    for name in ("auto", "ref", "unpacked"):
        t = runs[name][5]
        print(f"fleet throughput ({name}): offline_train "
              f"{t['offline_points_per_s']:.2f} replica-points/s, ingress "
              f"{t['ingress_rows_per_s']:.1f} rows/s, drain "
              f"{t['drain_points_per_s']:.2f} points/s, serve(1024 shared) "
              f"{t['serve_ms']:.3f} ms, serve([16, 64] per member) "
              f"{t['serve_member_ms']:.3f} ms", flush=True)
    return {"clause_counts_batch_replicated_packed":
            launched["clause_counts_batch_replicated_packed"]}


def phase_fleet_iris(torch, np, ce, fb):
    """The reference's own fleet geometry (BENCH_fleet.json fleet_drain):
    K = 8 iris machines, 64 points each, chunk 16, capacity 64, through
    ``OnlineFleet`` ("auto" and "ref") and through 8 K = 1 ``TMService``s
    seeded seed[r]: all bitwise equal (the stacking rule)."""
    from repro_torch.configs import tm_iris
    from repro_torch.core import init_runtime, init_state
    from repro_torch.data import iris
    from repro_torch.serve import OnlineFleet, ServiceConfig, TMService

    K, n, cap, chunk = 8, 64, 64, 16
    xs, ys = iris.load()
    rows = [np.roll(np.arange(len(xs)), -7 * r)[:n] for r in range(K)]
    out = {}
    for backend in ("auto", "ref"):
        cfg = dataclasses.replace(tm_iris.CONFIG.tm, backend=backend)
        rt = init_runtime(cfg, s=3.0, T=15, device="cuda")
        fleet = OnlineFleet(cfg, init_state(cfg, device="cuda"), rt,
                            n_replicas=K, buffer_capacity=cap, chunk=chunk,
                            seed=list(range(K)), device="cuda")
        for i in range(n):
            check(fleet.offer_rows(xs[[r[i] for r in rows]],
                                   ys[[r[i] for r in rows]]).all(),
                  "an iris fleet row was refused")
        fleet.service.flush()
        torch.cuda.synchronize()
        t = time.perf_counter()
        trained = fleet.drain(n)
        torch.cuda.synchronize()
        out[backend] = (fleet, trained, time.perf_counter() - t)
    cfg = dataclasses.replace(tm_iris.CONFIG.tm, backend="auto")
    singles, wall = [], 0.0
    for r in range(K):
        svc = TMService(cfg, init_state(cfg, device="cuda"), ServiceConfig(
            replicas=1, buffer_capacity=cap, chunk=chunk, seed=[r], s=3.0,
            T=15), device="cuda")
        for i in rows[r]:
            check(svc.submit(0, xs[i], int(ys[i])), "an iris row was refused")
        svc.flush()
        torch.cuda.synchronize()
        t = time.perf_counter()
        check(int(svc.drain(n)[0]) == n, "a single machine did not drain")
        torch.cuda.synchronize()
        wall += time.perf_counter() - t
        singles.append(svc)
    fa, ta, wa = out["auto"]
    fr, tr, wr = out["ref"]
    check(list(ta) == [n] * K and list(tr) == [n] * K,
          "the iris fleet did not drain")
    check(torch.equal(fa.ss.tm.ta_state, fr.ss.tm.ta_state)
          and np.array_equal(fa.service.rng_keys, fr.service.rng_keys),
          "iris fleet: the kernels differ from the plain versions")
    stacked = torch.stack([s.ss.tm.ta_state[0] for s in singles])
    keys = np.concatenate([s.rng_keys for s in singles])
    check(torch.equal(fa.ss.tm.ta_state, stacked)
          and np.array_equal(fa.service.rng_keys, keys),
          "iris fleet: OnlineFleet(8) differs from 8 K = 1 services")
    q = xs[:50]
    preds = fa.infer(q)
    check(all(np.array_equal(preds[r], singles[r].serve(q)[0])
              for r in range(K)), "iris fleet: served predictions differ")
    print(f"fleet_iris K={K} x {n} points, chunk {chunk}: OnlineFleet "
          f"{wa:.3f} s = {K * n / wa:.1f} points/s (ref {wr:.3f} s), 8 K = 1 "
          f"services {wall:.3f} s = {K * n / wall:.1f} points/s, fleet / "
          f"serial {wall / wa:.2f}x; fleet == 8 services == ref bitwise: "
          "True", flush=True)


def phase_profile_fleet(torch, np):
    """Where one K = 16 packed fleet drain chunk goes (16 steps, f = 784):
    torch.profiler over one tick, after the main paths."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import tm_mnist
    from repro_torch.core import init_state
    from repro_torch.data import mnist
    from repro_torch.serve import ServiceConfig, TMService

    cfg = tm_mnist.CONFIG.tm
    K = FLEET_K
    xs, ys = mnist.load(seed=SEED + 7, n_points=32 * K)
    svc = TMService(cfg, init_state(cfg, device="cuda"), ServiceConfig(
        replicas=K, packed=True, chunk=16,
        s=[s for s in FLEET_S for _ in FLEET_T],
        T=[t for _ in FLEET_S for t in FLEET_T]), device="cuda")
    for i in range(32):
        svc.submit_rows(xs[i * K:(i + 1) * K], ys[i * K:(i + 1) * K])
    svc.tick()                       # warm: first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.tick(on_chunk=lambda aux: None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile fleet drain chunk (K={K}, 16 steps, f={cfg.n_features}, "
          f"packed): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.4f}, kernel launches {launches} "
          f"({launches / 16:.1f} per step)", flush=True)
    print("profile fleet top device kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top), flush=True)


def _sets(np, osets, offline_limit):
    """A numpy ``Sets`` over every ordering, as the figure benchmarks build
    it: the offline set is analyzed whole and trained on its first
    ``offline_limit`` rows."""
    from repro_torch.core.manager import Sets

    O, n_off = osets.offline_y.shape
    train_valid = np.ones((O, n_off), dtype=bool)
    if offline_limit is not None:
        train_valid[:, offline_limit:] = False
    return Sets(
        offline_x=osets.offline_x, offline_y=osets.offline_y,
        offline_valid=np.ones((O, n_off), dtype=bool),
        validation_x=osets.validation_x, validation_y=osets.validation_y,
        validation_valid=np.ones(osets.validation_y.shape, dtype=bool),
        online_x=osets.online_x, online_y=osets.online_y,
        online_valid=np.ones(osets.online_y.shape, dtype=bool),
        offline_train_valid=train_valid)


def phase_engine(torch, np, ce, fb, label, params, osets, cases, sweep):
    """``run_orderings`` for each (name, schedule, offline_limit,
    SystemConfig) case and one ``CrossValRun.sweep`` (s_values, T_values,
    n_epochs, n_orderings),
    through backend "auto" and then "ref" on the card. Checks that both
    agree bit for bit and that the outputs are well formed, prints the
    curves and rates, checks the K3/K4/K9 launches of the "auto" runs
    against the counts the code implies, and returns them with each
    case's mean accuracy curve."""
    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.core import manager as mgr
    from repro_torch.core.tm import init_runtime
    from repro_torch.eval.crossval import CrossValRun, replicate_state

    dev = torch.device("cuda")
    O, n_off = osets.offline_y.shape
    n_onl = osets.online_y.shape[1]
    s_values, T_values, sweep_epochs, sweep_o = sweep
    counters = {"clause_counts_replicated": ce.clause_counts_replicated,
                "clause_counts_batch_replicated":
                    ce.clause_counts_batch_replicated,
                "feedback_plane_replicated": fb.feedback_plane_replicated}
    out = {}
    for backend in ("auto", "ref"):
        cfg = dataclasses.replace(params.tm, backend=backend)
        for c in counters.values():
            c.launches = 0
        runs = {}
        for name, schedule, limit, sys_cfg in cases:
            sets = convert.sets_from_numpy(_sets(np, osets, limit), dev)
            keys = rnd.split(rnd.PRNGKey(0, dev), O)
            rt = init_runtime(cfg, s=params.s_offline, T=params.T,
                              device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, accs, act = mgr.run_orderings(
                cfg, sys_cfg, replicate_state(cfg, O, dev), rt, sets,
                schedule, keys)
            torch.cuda.synchronize()
            runs[name] = (st.ta_state, accs, act, time.perf_counter() - t)
        res = CrossValRun(cfg, device=dev).sweep(
            osets.offline_x[:sweep_o], osets.offline_y[:sweep_o],
            osets.validation_x[:sweep_o], osets.validation_y[:sweep_o],
            s_values, T_values, n_epochs=sweep_epochs, seed=0)
        launches = {k: c.launches for k, c in counters.items()}
        out[backend] = (runs, res, launches)

    (runs_a, res_a, launches), (runs_r, res_r, _) = out["auto"], out["ref"]

    def steps(sc):
        return sc.n_offline_epochs * n_off + sc.n_online_cycles * n_onl

    for name, _, _, sys_cfg in cases:
        st_a, accs_a, act_a, wall = runs_a[name]
        st_r, accs_r, act_r, wall_r = runs_r[name]
        check(torch.equal(st_a, st_r), f"{label} {name}: banks differ "
              "between the kernels and the plain versions")
        check(torch.equal(accs_a, accs_r), f"{label} {name}: accuracies "
              "differ between the kernels and the plain versions")
        check(torch.equal(act_a, act_r), f"{label} {name}: activity differs")
        acc = accs_a.cpu().numpy()
        check(acc.shape == (O, 1 + sys_cfg.n_online_cycles, 3)
              and np.isfinite(acc).all() and acc.min() >= 0.0
              and acc.max() <= 1.0, f"{label} {name}: accuracies malformed")
        check(act_a.shape == (O, sys_cfg.n_online_cycles)
              and bool(torch.isfinite(act_a).all()),
              f"{label} {name}: activity malformed")
        curve = acc.mean(axis=0)
        print(f"{label} run_orderings {name} O={O} (SystemConfig"
              f"({sys_cfg.n_offline_epochs}, {sys_cfg.n_online_cycles})): "
              "mean validation "
              f"accuracy {curve[0, 1]:.4f} -> {curve[-1, 1]:.4f} (offline "
              f"{curve[0, 0]:.4f} -> {curve[-1, 0]:.4f}, online "
              f"{curve[0, 2]:.4f} -> {curve[-1, 2]:.4f}), auto == ref "
              f"bitwise: True; auto {wall:.3f} s = "
              f"{O * steps(sys_cfg) / wall:.1f} "
              f"replica-steps/s, ref {wall_r:.3f} s", flush=True)
    check(torch.equal(res_a.val_accuracy, res_r.val_accuracy),
          f"{label} sweep: validation accuracies differ between the kernels "
          "and the plain versions")
    va = res_a.val_accuracy.cpu().numpy()
    check(va.shape == (len(s_values), len(T_values), sweep_o)
          and np.isfinite(va).all() and va.min() >= 0.0 and va.max() <= 1.0,
          f"{label} sweep: accuracies malformed")
    mean = res_a.mean_accuracy.cpu().numpy()
    i, j = np.unravel_index(np.argmax(mean), mean.shape)
    print(f"{label} sweep R={res_a.replicas} (O={sweep_o} x s {s_values} x "
          f"T {T_values}, {sweep_epochs} epochs): best s={s_values[i]} "
          f"T={T_values[j]} mean val acc {mean[i, j]:.4f}; auto "
          f"{res_a.wall_s:.3f} s = {res_a.replicas_per_s:.2f} replicas/s = "
          f"{res_a.replicas * sweep_epochs * n_off / res_a.wall_s:.1f} "
          f"replica-steps/s, ref {res_r.wall_s:.3f} s; auto == ref bitwise: "
          "True", flush=True)

    # The counts the code implies: one K3 + K9 per datapoint step, one K4
    # per analysis block (offline, then once per cycle), one for the sweep.
    want = {"clause_counts_replicated":
            sum(steps(c[3]) for c in cases) + sweep_epochs * n_off,
            "clause_counts_batch_replicated":
            sum(1 + c[3].n_online_cycles for c in cases) + 1}
    want["feedback_plane_replicated"] = want["clause_counts_replicated"]
    print(f"{label} launches (auto): {json.dumps(launches)}, from the code: "
          f"{json.dumps(want)}", flush=True)
    check(launches == want, f"{label}: kernel launches differ from the "
          "counts the code implies")
    check(all(n > 0 for n in launches.values()),
          f"{label}: a replica-first kernel never launched")
    curves = {name: runs_a[name][1].mean(dim=0).cpu().numpy()
              for name, _, _, _ in cases}
    return launches, curves


# The paper's figure runs. Fig 4's online learning runs over all 120
# orderings at the paper's 10 offline epochs and 16 cycles; the
# class-introduction (Figs 6/7) and stuck-at-fault (Figs 8/9) pairs run at
# the reference's full-scale test protocol (tests/test_paper_figures.py:
# 24 orderings, SystemConfig(10, 16), the event at cycle 5, 75% of the TAs
# stuck at 0), each through usecases.run_system on "auto" and on "ref".
PAPER_CASES = {                 # name -> (fig, orderings, offline_limit)
    "fig4_online_learning": (4, 120, 20),
    "fig6_intro_frozen": (6, 24, None),
    "fig7_intro_online": (7, 24, None),
    "fig8_faults_frozen": (8, 24, 20),
    "fig9_faults_online": (9, 24, 20),
}
PAPER_EVENT = 5                 # the cycle of the introduction / injection
# Runs at a time: on one H100 a run took 19.7 s alone, 29-31 s five at a
# time and 69 s ten at a time (processes sharing one card are
# time-sliced), so two waves of five finish first (72.7 s against 91.7
# for all ten).
PAPER_WORKERS = 5
PAPER_FAULT_FRACTION = 0.75
PAPER_KERNELS = ("clause_counts_replicated", "clause_counts_batch_replicated",
                 "feedback_plane_replicated")


def in_workers(jobs: list, workers: int | None = None) -> list:
    """Each ``(fn, *args)`` in a worker process (forked from the ranks'
    fork server, ``launch.ranks.context``), ``workers`` at a time
    (default: all at once); their results in order. The TM runs are bound
    by the host's launches, one core each, so separate processes run them
    side by side on the card. Every process ends before this returns."""
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import ranks

    with ProcessPoolExecutor(max_workers=workers or len(jobs),
                             mp_context=ranks.context()) as pool:
        futures = [pool.submit(fn, *args) for fn, *args in jobs]
        return [f.result() for f in futures]


def _paper_job(name: str, backend: str) -> dict:
    """One figure run on the card, in a worker process: the run's bank,
    accuracies, activity, mean curves (``usecases.mean_curves``, as
    ``run_schedule`` averages them), wall and launches."""
    import torch

    from repro_torch.eval import usecases
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb

    torch.set_num_threads(1)
    fig, O, limit = PAPER_CASES[name]
    schedule = usecases.figure_schedule(fig, PAPER_EVENT,
                                        PAPER_FAULT_FRACTION)
    zero_counters(ce, fb)
    torch.cuda.synchronize()
    res = usecases.run_system(schedule, n_orderings=O, n_cycles=16,
                              offline_limit=limit, seed=0, device="cuda",
                              backend=backend)
    torch.cuda.synchronize()
    curve, activity = usecases.mean_curves(res)
    return {"bank": res.state.ta_state.cpu().numpy(),
            "accs": res.accuracies.cpu().numpy(),
            "act": res.activity.cpu().numpy(), "curve": curve,
            "activity": activity, "wall": res.wall_s,
            "launches": counters(ce, fb)}


def _fmt_curve(np, c) -> str:
    return "[" + " ".join(f"{v:.4f}" for v in np.asarray(c)) + "]"


def phase_paper(torch, np, ce, fb):
    """The paper's iris setup through the replica-first engine: the
    1080-replica sweep (120 orderings x s {1.375, 2.0, 3.0} x T {5, 10,
    15}), then the PAPER_CASES runs on "auto" and "ref", each in a worker
    process on the card, PAPER_WORKERS at a time, held bit for bit and to
    the reference's full-scale bands for Figs 4 and 6-9."""
    from repro_torch.configs import tm_iris
    from repro_torch.data import blocks

    params = tm_iris.CONFIG
    osets, _ = blocks.iris_paper_sets(n_orderings=params.n_orderings)
    check(osets.offline_x.shape == (120, 30, 16),
          "the iris paper sets are not 120 orderings of 30 x 16")
    launches, _ = phase_engine(
        torch, np, ce, fb, "paper", params, osets, [],
        ((1.375, 2.0, 3.0), (5, 10, 15), params.n_offline_epochs, 120))

    jobs = [(_paper_job, name, backend) for name in PAPER_CASES
            for backend in ("auto", "ref")]
    t = time.perf_counter()
    done = in_workers(jobs, PAPER_WORKERS)
    wall = time.perf_counter() - t
    runs = {(name, backend): r for (_, name, backend), r in zip(jobs, done)}
    n_off, n_onl = osets.offline_y.shape[1], osets.online_y.shape[1]
    steps = params.n_offline_epochs * n_off + 16 * n_onl
    want = {"clause_counts_replicated": steps,
            "clause_counts_batch_replicated": 1 + 16,
            "feedback_plane_replicated": steps}
    curves = {}
    for name, (_, O, _) in PAPER_CASES.items():
        a, r = runs[name, "auto"], runs[name, "ref"]
        for key in ("bank", "accs", "act", "curve", "activity"):
            check(np.array_equal(a[key], r[key]), f"paper {name}: {key} "
                  "differs between the kernels and the plain versions")
        check(a["accs"].shape == (O, 17, 3)
              and np.isfinite(a["accs"]).all() and a["accs"].min() >= 0.0
              and a["accs"].max() <= 1.0, f"paper {name}: accuracies "
              "malformed")
        check(a["act"].shape == (O, 16) and np.isfinite(a["act"]).all(),
              f"paper {name}: activity malformed")
        got = {k: a["launches"][k] for k in PAPER_KERNELS}
        check(got == want, f"paper {name}: launches {got}, the code "
              f"implies {want}")
        check(not any(r["launches"].values()), f"paper {name}: the plain "
              "run launched a kernel")
        for k in PAPER_KERNELS:
            launches[k] += got[k]
        c = curves[name] = a["curve"]
        print(f"paper {name} O={O} SystemConfig(10, 16): validation "
              f"{_fmt_curve(np, c[:, 1])}, offline {c[0, 0]:.4f} -> "
              f"{c[-1, 0]:.4f}, online {c[0, 2]:.4f} -> {c[-1, 2]:.4f}, "
              f"mean activity {float(a['activity'].mean()):.6f}; auto == "
              f"ref bitwise (banks, accuracies, activity): True; auto "
              f"{a['wall']:.3f} s, ref {r['wall']:.3f} s, launches (auto) "
              f"{json.dumps(got)}", flush=True)
    print(f"paper: {len(jobs)} runs, {PAPER_WORKERS} processes at a time, "
          f"{wall:.2f} s to the last", flush=True)

    # The reference's full-scale claims (tests/test_paper_figures.py: the
    # Fig-4 gains, and the slow tests' Fig 6-9 bands, word for word).
    c = curves["fig4_online_learning"]
    gain_val, gain_onl = c[-1, 1] - c[0, 1], c[-1, 2] - c[0, 2]
    print(f"paper Fig-4 gains (mean over "
          f"{PAPER_CASES['fig4_online_learning'][1]} orderings): validation "
          f"{gain_val:+.4f}, online {gain_onl:+.4f}", flush=True)
    check(gain_val >= 0.04 and gain_onl >= 0.04,
          "online learning did not raise the accuracy (Fig. 4)")
    e = PAPER_EVENT
    c6, c7 = curves["fig6_intro_frozen"], curves["fig7_intro_online"]
    c8, c9 = curves["fig8_faults_frozen"], curves["fig9_faults_online"]

    def flat(c):                # np.testing.assert_allclose(atol=1e-6)
        return bool(np.allclose(c[e + 1:, 1], c[e + 1, 1], rtol=1e-7,
                                atol=1e-6))

    bands = {
        "Fig 6 drops at the introduction (<= -0.15)":
            c6[e + 1, 1] - c6[e, 1] <= -0.15,
        "Fig 6 stays flat after it (atol 1e-6)": flat(c6),
        "Fig 7 recovers from its dip (>= +0.02)":
            c7[-1, 1] >= c7[e + 1, 1] + 0.02,
        "Fig 7 ends above Fig 6 (>= +0.15)": c7[-1, 1] >= c6[-1, 1] + 0.15,
        "Fig 8 drops at the injection (<= -0.05)":
            c8[e + 1, 1] - c8[e, 1] <= -0.05,
        "Fig 8 stays flat after it (atol 1e-6)": flat(c8),
        "Fig 9 ends above Fig 8 (>= +0.04)": c9[-1, 1] >= c8[-1, 1] + 0.04,
    }
    print(f"paper Figs 6-9 ({PAPER_CASES['fig6_intro_frozen'][1]} "
          f"orderings, event at cycle {e}): Fig 6 drop "
          f"{c6[e + 1, 1] - c6[e, 1]:+.4f}, Fig 7 recovery "
          f"{c7[-1, 1] - c7[e + 1, 1]:+.4f}, Fig 7 - Fig 6 at the end "
          f"{c7[-1, 1] - c6[-1, 1]:+.4f}, Fig 8 drop "
          f"{c8[e + 1, 1] - c8[e, 1]:+.4f}, Fig 9 - Fig 8 at the end "
          f"{c9[-1, 1] - c8[-1, 1]:+.4f}; bands: "
          + ", ".join(f"{k}: {bool(v)}" for k, v in bands.items()),
          flush=True)
    for k, v in bands.items():
        check(bool(v), f"paper: {k} fails on the card's curves")
    return launches


# The examples phase: each ``examples/<name>_torch.py`` through its
# ``main(argv)`` on the card, at the reference's defaults but for the full
# MNIST width and a temporary checkpoint directory. The class_introduction
# and fault_mitigation examples do not run here: their usecases functions
# build each run with usecases.figure_schedule and go through
# usecases.run_system, which phase paper runs on the card at full depth
# for Figs 6-9 (their Fig 5 run and fault_mitigation's default 20%
# fraction run only in the CPU tests). Each example names the kernels
# whose launch counts must move (the CUDA kernels on its path).
EXAMPLES = (
    ("quickstart", [], ("clause_counts", "clause_counts_batch",
                        "feedback_plane") + PAPER_KERNELS),
    ("serve_fleet", [], PAPER_KERNELS),
    ("mnist_scale", ["--side", "28"], PAPER_KERNELS),
    ("tunable_serving", [], ("clause_counts_replicated",
                             "feedback_plane_replicated",
                             "clause_counts_batch_pruned_replicated")),
    ("serve_lm", [], ()),
    ("train_lm", ["--small", "--ckpt"], ()),
    ("online_lm_adaptation", ["--ckpt"], ()),
)


def _example_job(name: str, argv: list) -> dict:
    """``examples/<name>_torch.py``'s ``main(argv)`` on the card, in a
    worker process: what it returned, what it printed, its wall and the
    kernels' launches."""
    import contextlib
    import importlib.util
    import io

    import torch

    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    zero_counters(ce, fb)
    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = mod.main(argv)
    torch.cuda.synchronize()
    return {"result": result, "stdout": out.getvalue(),
            "wall": time.perf_counter() - t, "launches": counters(ce, fb)}


def _in_unit(np, *arrays) -> bool:
    return all(np.isfinite(np.asarray(a, dtype=np.float64)).all()
               and 0.0 <= np.min(a) and np.max(a) <= 1.0 for a in arrays)


def phase_examples(torch, np, ce, fb):
    """The examples, each in a process of its own on the card, all at
    once: each returns, prints, gives finite accuracies and losses in
    range, and moves the launch counters of the kernels on its path."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(_example_job, name,
                 [a if a != "--ckpt" else f"--ckpt={tmp}/{name}"
                  for a in argv])
                for name, argv, _ in EXAMPLES]
        t = time.perf_counter()
        done = in_workers(jobs)
        wall = time.perf_counter() - t
    for (name, _, kernels), (_, _, argv), r in zip(EXAMPLES, jobs, done):
        print(f"--- example {name}_torch {' '.join(argv)}: wall "
              f"{r['wall']:.2f} s, launches " + json.dumps(
                  {k: n for k, n in r["launches"].items() if n}),
              flush=True)
        print(r["stdout"].rstrip(), flush=True)
        for k in kernels:
            check(r["launches"][k] > 0, f"example {name}: {k} never "
                  "launched")
        out = r["result"]
        if name == "quickstart":
            check(out["curve"].shape == (17, 3)
                  and _in_unit(np, out["curve"], out["base"],
                               out["service_accuracy"])
                  and len(out["service_accuracy"]) == 2
                  and set(out["preds"].tolist()) <= {0, 1, 2},
                  "example quickstart: outputs malformed")
            steps = 10 * 30 + 16 * 60
            got = {k: r["launches"][k] for k in PAPER_KERNELS}
            check(got == {"clause_counts_replicated": steps,
                          "clause_counts_batch_replicated": 17,
                          "feedback_plane_replicated": steps},
                  f"example quickstart: the engine's launches {got}")
        elif name == "serve_fleet":
            check(_in_unit(np, out["base"], out["final"])
                  and out["final"].shape == (4,),
                  "example serve_fleet: accuracies malformed")
        elif name == "mnist_scale":
            check(_in_unit(np, out["base"], out["served"])
                  and out["served"].min() > 0.3,
                  "example mnist_scale: accuracies malformed")
        elif name == "tunable_serving":
            check(sorted(out["rows"]) == [0.25, 0.5, 1.0]
                  and _in_unit(np, [a for _, a, _ in out["rows"].values()]),
                  "example tunable_serving: accuracies malformed")
        elif name == "serve_lm":
            check(out.shape == (4, 24) and out.dtype == np.int32
                  and out.min() >= 0, "example serve_lm: tokens malformed")
        elif name == "train_lm":
            check(out.steps_run == 200 and not out.fault_events
                  and np.isfinite(out.losses).all(),
                  "example train_lm: training malformed")
            print(f"example train_lm: loss {out.losses[0]:.4f} -> "
                  f"{out.losses[-1]:.4f}", flush=True)
        else:
            losses = [out["offline"]] + [x for _, x in out["history"]]
            check(len(losses) == 8 and np.isfinite(losses).all(),
                  "example online_lm_adaptation: losses malformed")
    print(f"examples: {len(jobs)} examples in {len(jobs)} processes side "
          f"by side, {wall:.2f} s to the last", flush=True)


def phase_wide(torch, np, ce, fb):
    """The engine at the full MNIST width (f = 784): 8 orderings through
    the Fig-3 flow and a 16-replica sweep."""
    from repro_torch.configs import tm_mnist
    from repro_torch.core import manager as mgr
    from repro_torch.data import blocks

    params = tm_mnist.CONFIG
    check(params.tm.n_features == 784 and params.tm.backend == "auto",
          "the preset is not the full-width machine on backend auto")
    osets, _ = blocks.mnist_paper_sets(n_orderings=8)
    cases = [("online_learning", mgr.make_schedule(online_s=params.s_online),
              params.offline_limit, mgr.SystemConfig(2, 2))]
    launches, _ = phase_engine(torch, np, ce, fb, "wide", params, osets,
                               cases, ((1.5, 2.0), (24, 32), 1, 4))
    return launches


def phase_profile_epoch(torch, np):
    """Where one offline epoch of the f = 784, O = 8 system goes:
    torch.profiler over ``train_epochs_replicated`` for one epoch (30
    steps), after the main paths, so no launch count includes it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import convert
    from repro_torch import random as rnd
    from repro_torch.configs import tm_mnist
    from repro_torch.core import feedback as fb_mod
    from repro_torch.core.manager import train_valid
    from repro_torch.core.tm import init_runtime
    from repro_torch.data import blocks
    from repro_torch.eval.crossval import replicate_state

    params = tm_mnist.CONFIG
    cfg = params.tm
    dev = torch.device("cuda")
    osets, _ = blocks.mnist_paper_sets(n_orderings=8)
    sets = convert.sets_from_numpy(_sets(np, osets, params.offline_limit),
                                   dev)
    O, n = osets.offline_y.shape
    rt = init_runtime(cfg, s=params.s_offline, T=params.T, device=dev)
    keys = rnd.split(rnd.PRNGKey(1, dev), O)

    def epoch():
        return fb_mod.train_epochs_replicated(
            cfg, replicate_state(cfg, O, dev), rt, sets.offline_x,
            sets.offline_y, keys, 1, valid=train_valid(sets))

    epoch()                          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    devk = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in devk) / 1e3
    launches = sum(e.count for e in ka
                   if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    top = sorted(devk, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile offline epoch (O={O}, {n} steps, f={cfg.n_features}): "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.4f}, kernel launches {launches} "
          f"({launches / n:.1f} per step)", flush=True)
    print("profile epoch top device kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top), flush=True)


def phase_profile(torch, np):
    """Where one drain chunk's time goes: torch.profiler over one tick of
    16 points at the full width (after the main path, so no launch count
    of the main path includes it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import tm_mnist
    from repro_torch.core import init_state
    from repro_torch.data import mnist
    from repro_torch.serve import ServiceConfig, TMService

    cfg = tm_mnist.CONFIG.tm
    xs, ys = mnist.load(seed=SEED + 2, n_points=32)
    svc = TMService(cfg, init_state(cfg, device="cuda"),
                    ServiceConfig(chunk=16, s=2.0, T=32), device="cuda")
    for x, y in zip(xs, ys):
        svc.submit(0, x, int(y))
    svc.tick()                       # warm: first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.tick(on_chunk=lambda aux: None)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile drain chunk (16 points, f=784): wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1.0 - busy / wall:.4f}, kernel launches {launches}", flush=True)
    print("profile top device kernels: " + "; ".join(
        f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top), flush=True)


def phase_parity_pruned(torch, np, ce, probe, word_err):
    """K7, the four pruned entries, against their plain versions, against
    the gather + K2/K4/K5/K6 kernels on the compacted bank, and packed
    against unpacked, with ``torch.equal``; then timed at the
    OVERPROVISIONED f = 784 shapes (C = 10, J = 128, B = 1024; K = 1 and
    the K = 16 fleet, D = 1) at M = 32 and M = 128, beside gather + K2/K4/
    K5/K6 and the full-bank kernel. Returns the four kernel records; the
    word entries' bound takes the b1 peak of ``probe``, their error also
    ``word_err`` (phase parity_words)."""
    from repro_torch.kernels import packing
    from repro_torch.kernels.ref import gather_include

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 14)
    C, J = PRUNED_C, PRUNED_J
    names = ("clause_counts_batch_pruned", "clause_counts_batch_pruned_packed",
             "clause_counts_batch_pruned_replicated",
             "clause_counts_batch_pruned_replicated_packed")
    err = {k: word_err.get(k, 0) for k in names}
    n_checks = {k: 0 for k in names}

    def operands(R, D, f, B):
        inc = torch.from_numpy(rng.random((R, C, J, 2 * f)) < 0.05).to(dev)
        inc[:, :, 0, :] = False                 # an all-empty clause row
        inc[:, :, -1, :] = True                 # an all-include row
        x = torch.from_numpy(rng.random((D, B, f)) < 0.5).to(dev)
        return (inc, torch.cat([x, ~x], -1), packing.pack_include(inc, f),
                packing.pack_literals(x))

    def sels(R):
        """[R, C, M] on the card: permutation prefixes at M = 1, J/2, J
        and ids with repeats at M = J/2 and J."""
        out = []
        for M in (1, J // 2, J):
            out.append(np.stack([np.stack([rng.permutation(J)[:M]
                                           for _ in range(C)])
                                 for _ in range(R)]))
        for M in (J // 2, J):
            rep = rng.integers(0, J, (R, C, M))
            rep[..., -1] = rep[..., 0]
            out.append(rep)
        return [torch.from_numpy(a.astype(np.int32)).to(dev) for a in out]

    def hold(name, got, wants, what):
        ok = all(torch.equal(g, w) for want in wants
                 for g, w in zip(got, want))
        err[name] = max(err[name], *(
            int((g.long() - w.long()).abs().max()) for want in wants
            for g, w in zip(got, want)))
        n_checks[name] += 1
        check(ok, f"{name} differs from its plain version, the gather + "
                  f"kernel route or the other datapath at {what}")

    for f in PRUNED_F:
        for R, D in PRUNED_RD:
            for B in PRUNED_B:
                inc, lits, inc_w, lit_w = operands(R, D, f, B)
                for sel in sels(R):
                    M = sel.shape[-1]
                    what = f"f={f} R={R} D={D} B={B} M={M}"
                    got = ce.clause_counts_batch_pruned_replicated(inc, sel,
                                                                   lits)
                    gotw = ce.clause_counts_batch_pruned_replicated_packed(
                        inc_w, sel, lit_w)
                    gath = ce.clause_counts_batch_replicated(
                        gather_include(inc, sel).reshape(R, C * M, -1), lits)
                    gathw = ce.clause_counts_batch_replicated_packed(
                        gather_include(inc_w, sel).reshape(R, C * M, -1),
                        lit_w)
                    # plain versions replica by replica: the packed one's
                    # SWAR temporaries grow with R * C * M * B * W
                    plain = [ce.clause_counts_batch_pruned_replicated_plain(
                        inc[r:r + 1], sel[r:r + 1],
                        lits[r % D:r % D + 1]) for r in range(R)]
                    plainw = [
                        ce.clause_counts_batch_pruned_replicated_packed_plain(
                            inc_w[r:r + 1], sel[r:r + 1],
                            lit_w[r % D:r % D + 1]) for r in range(R)]
                    torch.cuda.synchronize()
                    plain = [torch.cat([p[i] for p in plain])
                             for i in range(2)]
                    plainw = torch.cat(plainw)
                    hold(names[2], got, [plain, gath], what)
                    hold(names[3], [gotw], [[plainw], [gathw], [got[0]]],
                         what)
                    if R == 1:
                        one = ce.clause_counts_batch_pruned(inc[0], sel[0],
                                                            lits[0])
                        onew = ce.clause_counts_batch_pruned_packed(
                            inc_w[0], sel[0], lit_w[0])
                        torch.cuda.synchronize()
                        hold(names[0], one, [[got[0][0], got[1][0]],
                                             ce.clause_counts_batch_pruned_plain(
                                                 inc[0], sel[0], lits[0])],
                             what)
                        hold(names[1], [onew], [
                            [gotw[0]],
                            [ce.clause_counts_batch_pruned_packed_plain(
                                inc_w[0], sel[0], lit_w[0])]], what)
            print(f"parity K7 pruned f={f} (R, D) {PRUNED_RD} x B "
                  f"{PRUNED_B} x M {{1, {J // 2}, {J}}} (prefixes and "
                  "repeats) equal=True", flush=True)
    # K7 on bytes at the tensor-core body's edges: R = 4 banks of C = 3
    # classes x J = 40 clauses on D = 2 streams, each call taking the next
    # selection in turn (permutation prefixes at M = 1, 20, 40: 3 to 120
    # compacted rows; ids with repeats at M = 20; each as int32 and int64),
    # and the K = 1 entry on replica 0; one launch a call, against the
    # plain versions on bool operands.
    EC, EJ = 3, 40
    edge_sels = [np.stack([np.stack([rng.permutation(EJ)[:M]
                                     for _ in range(EC)]) for _ in range(4)])
                 for M in (1, EJ // 2, EJ)]
    rep = rng.integers(0, EJ, (4, EC, EJ // 2))
    rep[..., -1] = rep[..., 0]
    edge_sels.append(rep)
    edge_sels = [torch.from_numpy(a.astype(dt)).to(dev) for a in edge_sels
                 for dt in (np.int32, np.int64)]
    turn = [0]

    def hold_k7(inc, lits, view, lview, what):
        sel = edge_sels[turn[0] % len(edge_sels)]
        turn[0] += 1
        what = f"R=4 D=2 C={EC} J={EJ} M={sel.shape[-1]} {sel.dtype} {what}"
        k_rep, k_one = (ce.clause_counts_batch_pruned_replicated,
                        ce.clause_counts_batch_pruned)
        before = (k_rep.launches, k_one.launches)
        got = k_rep(view(inc), sel, lview(lits))
        one = k_one(view(inc)[0], sel[0], lview(lits)[0])
        check((k_rep.launches, k_one.launches)
              == (before[0] + 1, before[1] + 1),
              f"K7 on bytes launched other than once a call at {what}")
        inc_b, lits_b = inc.to(torch.bool), lits.to(torch.bool)
        want = ce.clause_counts_batch_pruned_replicated_plain(inc_b, sel,
                                                              lits_b)
        want1 = ce.clause_counts_batch_pruned_plain(inc_b[0], sel[0],
                                                    lits_b[0])
        torch.cuda.synchronize()
        hold(names[2], got, [want], what)
        hold(names[0], one, [want1], what)

    byte_edges(torch, np, rng, dev, hold_k7, (4, EC, EJ), (2,))
    # and on the 128 x 128 tiles: R = 16 banks of 3 x 120 clauses, 100
    # elected a class (300 rows), a permutation prefix or ids with repeats
    big = [np.stack([np.stack([rng.permutation(120)[:BIG_ROWS // 3]
                               for _ in range(3)]) for _ in range(BIG_R)]),
           rng.integers(0, 120, (BIG_R, 3, BIG_ROWS // 3))]
    edge_sels[:] = [torch.from_numpy(a.astype(dt)).to(dev) for a in big
                    for dt in (np.int32, np.int64)]
    EC, EJ = 3, 120
    byte_edges(torch, np, rng, dev, hold_k7, (BIG_R, EC, EJ), (2,),
               (BIG_B,))
    print(f"parity K7 on bytes R=4 D=2 C=3 J=40 L {BYTE_L} x "
          f"{BYTE_KINDS} x B {BYTE_B} x {[p[0] for p in PLACEMENTS]}, "
          f"8 selections in turn; R={BIG_R} C=3 J=120 M={BIG_ROWS // 3} "
          f"B={BIG_B} (128 x 128 tiles), 4 selections in turn equal=True",
          flush=True)
    print(f"parity pruned checks: {json.dumps(n_checks)}", flush=True)

    rate = probe["b1_mma_peak_per_s"]
    f, B = 784, 1024
    recs = []
    for name, replaces, R, packed in (
        (names[0], "src/repro/kernels/clause_eval.py:524", 1, False),
        (names[1], "src/repro/kernels/clause_eval.py:546", 1, True),
        (names[2], "src/repro/kernels/clause_eval.py:535", FLEET_K, False),
        (names[3], "src/repro/kernels/clause_eval.py:557", FLEET_K, True),
    ):
        inc, lits, inc_w, lit_w = operands(R, 1, f, B)
        bank, lit = (inc_w, lit_w) if packed else (inc, lits)
        W = inc_w.shape[-1]
        full_fn = (ce.clause_counts_batch_replicated_packed if packed
                   else ce.clause_counts_batch_replicated)
        kern_fn = getattr(ce, name)
        plain_fn = getattr(ce, name + "_plain")
        rec = None
        for M in (J // 4, J):        # budgets 0.25 and 1.0
            sel = torch.from_numpy(np.stack([np.stack([
                rng.permutation(J)[:M] for _ in range(C)])
                for _ in range(R)]).astype(np.int32)).to(dev)
            if R == 1:
                args = (bank[0], sel[0], lit[0])
            else:
                args = (bank, sel, lit)
            kern_ms = time_ms(torch, lambda: kern_fn(*args))
            gather_ms = time_ms(torch, lambda: full_fn(
                gather_include(bank, sel).reshape(R, C * M, -1), lit))
            full_ms = time_ms(torch, lambda: full_fn(
                bank.reshape(R, C * J, -1), lit))
            if packed:
                # the elected rows, their int32 ids, the literals and the
                # counts; 32 W bit operations a row and column
                nbytes = (R * C * M * W * 4 + R * C * M * 4 + B * W * 4
                          + R * C * M * B * 4)
                ops = 32 * R * C * M * B * W
                b_ms, b_by = bound(nbytes, ops, rate)
            else:
                nbytes, ops = k7_bytes_work(R, C, M, f, B)
                b_ms, b_by = bound(nbytes, ops, INT8_OPS_PER_S)
            plain_ms = (time_ms(torch, lambda: plain_fn(*args), inner=2,
                                reps=5) if M < J else None)
            print(f"time {name} (R={R} D=1 C={C} J={J} M={M} f={f} B={B}): "
                  f"kernel {kern_ms:.5f} ms, plain "
                  f"{'not measured' if plain_ms is None else f'{plain_ms:.5f} ms'}"
                  f", gather + {'K6' if packed else 'K4'} {gather_ms:.5f} ms, "
                  f"full-bank {'K6' if packed else 'K4'} {full_ms:.5f} ms, "
                  f"library None, bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
                  f"{ops:.0f} "
                  f"{f'bit operations at the b1 peak {rate:.4g}/s' if packed else 'int8 ops'})",
                  flush=True)
            if M < J:
                rec = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/clause_eval.cu",
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err[name], "ms": kern_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "shape": f"R={R} C={C} J={J} M={M} "
                    f"f={f} B={B}", "gather_then_kernel_ms": gather_ms,
                    "full_bank_kernel_ms": full_ms}
            else:
                rec.update(ms_full_budget=kern_ms, bound_ms_full_budget=b_ms,
                           gather_then_kernel_ms_full_budget=gather_ms)
        recs.append(rec)
    return recs


def _tunable_service(torch, cfg, bank, tc, packed, backend, data):
    """A K = 16 tunable fleet on the trained ``bank`` with the 4 x 4 s x T
    grid, calibrated on the train split."""
    from repro_torch.core.tm import TMState
    from repro_torch.serve import ServiceConfig, TMService

    tr_x, tr_y = data[:2]
    svc = TMService(
        dataclasses.replace(cfg, backend=backend), TMState(bank.clone()),
        ServiceConfig(replicas=FLEET_K, packed=packed, buffer_capacity=64,
                      chunk=16, s=[s for s in FLEET_S for _ in FLEET_T],
                      T=[t for _ in FLEET_S for t in FLEET_T], seed=SEED,
                      tunable=tc),
        eval_x=tr_x, eval_y=tr_y, device="cuda")
    svc.calibrate(tr_x, tr_y)
    return svc


def phase_tunable(torch, np, ce, fb):
    """Runtime-tunable serving at full width: configs/tm_mnist.
    OVERPROVISIONED (f = 784, C = 10, J = 128) as a K = 16 fleet with a
    4 x 4 s x T grid on procedural MNIST, offline-trained 200 rows x 2
    epochs (cut from the preset's 10), calibrated on the 200-row train
    split; the 250-row test split and a 1024-row batch served at budgets
    {1, 0.5, 0.25, 0.125} x weight_bits {0, 4} x early exit {off, group
    16}, unpacked and packed through the kernels ("auto") and unpacked on
    "ref"; then member 0 as one machine through the reference benchmark's
    K = 1 measurement (``predict_batch_pruned``, ``analyze_pruned``), the
    save -> restore continuation and the adapt rule. Returns the K7
    launches of this run."""
    from repro_torch import random as rnd
    from repro_torch.configs import tm_mnist
    from repro_torch.core import accuracy as acc_mod
    from repro_torch.core import init_state
    from repro_torch.core import tm as tm_mod
    from repro_torch.data import mnist
    from repro_torch.serve import ServiceConfig, TMService, TunableConfig
    from repro_torch.serve.tunable import m_for_budget

    cfg = tm_mnist.OVERPROVISIONED.tm
    check(cfg.n_features == 784 and cfg.max_clauses == 128
          and cfg.max_classes == 10, "OVERPROVISIONED is not f=784, J=128")
    tr_x, tr_y, te_x, te_y = mnist.splits(n_train=200, n_test=250, seed=SEED)
    big, _ = mnist.load(seed=SEED + 9, n_points=1024)
    data = (tr_x, tr_y, te_x, te_y, big)
    K, J = FLEET_K, cfg.max_clauses
    K7 = ("clause_counts_batch_pruned", "clause_counts_batch_pruned_packed",
          "clause_counts_batch_pruned_replicated",
          "clause_counts_batch_pruned_replicated_packed")
    expect = dict.fromkeys(K7, 0)

    def k7_call(what, fn, name=None, group=None):
        """Run ``fn`` and hold its K7 launches to the count its path
        implies: none on backend "ref" (``name`` None), one of ``name``
        without early exit, and with it one a ranked group that the
        slowest request needed, ceil(max evaluated / group) (``fn`` then
        returns ``(preds, aux)``). Returns (``fn``'s result, launches)."""
        before = counters(ce, fb)
        out = fn()
        after = counters(ce, fb)
        got = {k: after[k] - before[k] for k in K7}
        want = dict.fromkeys(K7, 0)
        if name is not None:
            want[name] = (1 if group is None
                          else -(-int(out[1].evaluated.max()) // group))
        check(got == want, f"{what}: K7 launches {got}, expected {want}")
        for k in K7:
            expect[k] += want[k]
        return out, sum(got.values())

    zero_counters(ce, fb)
    t0 = time.perf_counter()
    trainer = TMService(
        cfg, init_state(cfg, rnd.PRNGKey(SEED, "cuda"), device="cuda"),
        ServiceConfig(replicas=K, s=[s for s in FLEET_S for _ in FLEET_T],
                      T=[t for _ in FLEET_S for t in FLEET_T], seed=SEED),
        eval_x=te_x, eval_y=te_y, device="cuda")
    base = trainer.offline_train(tr_x, tr_y, n_epochs=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bank = trainer.ss.tm.ta_state
    print(f"tunable fleet K={K} f={cfg.n_features} J={J}: offline 200 rows "
          f"x 2 epochs "
          f"{train_s:.2f} s ({2 * 200 * K / train_s:.1f} replica-points/s), "
          f"held-out acc {np.round(base, 4).tolist()}", flush=True)
    plain = {name: trainer.serve(x) for name, x in (("test", te_x),
                                                    ("big", big))}

    BUDGETS = (1.0, 0.5, 0.25, 0.125)
    runs = {}
    for variant, packed, backend in (("auto", False, "auto"),
                                     ("packed", True, "auto"),
                                     ("ref", False, "ref")):
        for wb in (0, 4):
            for group in (None, 16):
                tc = TunableConfig(budget=1.0, weight_bits=wb,
                                   early_exit=group is not None,
                                   group=group or 16)
                svc = _tunable_service(torch, cfg, bank, tc, packed, backend,
                                       data)
                k7_name = (None if backend == "ref" else K7[3] if packed
                           else K7[2])
                for b in BUDGETS:
                    for name, x in (("test", te_x), ("big", big)):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        (preds, aux), k7 = k7_call(
                            f"tunable {variant} wb={wb} exit={group} "
                            f"budget={b} {name}",
                            lambda: svc.serve(x, budget=b, return_aux=True),
                            k7_name, group)
                        ms = (time.perf_counter() - t) * 1e3
                        runs[(variant, wb, group, b, name)] = (
                            preds, aux.evaluated, ms, k7, svc.tuner.order,
                            svc.tuner.weights)
    # the checks
    for key, (preds, ev, ms, k7, order, w) in runs.items():
        variant, wb, group, b, name = key
        ref = runs[("ref", wb, group, b, name)]
        check(np.array_equal(preds, ref[0]) and np.array_equal(ev, ref[1])
              and np.array_equal(order, ref[4])
              and (w is None) == (ref[5] is None)
              and (w is None or np.array_equal(w, ref[5])),
              f"tunable {key}: differs from backend 'ref'")
        un = runs[("auto", wb, group, b, name)]
        check(np.array_equal(preds, un[0]) and np.array_equal(ev, un[1]),
              f"tunable {key}: packed differs from unpacked")
        off = runs[(variant, wb, None, b, name)]
        check(np.array_equal(preds, off[0]),
              f"tunable {key}: early exit changed a prediction")
        check(preds.shape == (FLEET_K, len(ev[0])) and preds.min() >= 0
              and preds.max() < cfg.max_classes, f"tunable {key}: malformed")
    for name in ("test", "big"):
        for variant in ("auto", "packed", "ref"):
            check(np.array_equal(runs[(variant, 0, None, 1.0, name)][0],
                                 plain[name]),
                  f"tunable {variant} {name}: budget 1.0 with unit weights "
                  "and no exit differs from plain serve")
    for wb in (0, 4):
        for group in (None, 16):
            for b in BUDGETS:
                row = runs[("auto", wb, group, b, "test")]
                acc = float((row[0] == te_y[None]).mean())
                big_row = runs[("auto", wb, group, b, "big")]
                pk = runs[("packed", wb, group, b, "big")]
                print(f"tunable serve wb={wb} exit={group} budget={b}: "
                      f"test acc {acc:.4f} (mean of {K}), mean evaluated "
                      f"{row[1].mean():.2f} / {m_for_budget(b, J)}; serve(250) "
                      f"{row[2]:.3f} ms, serve(1024) {big_row[2]:.3f} ms "
                      f"(packed {pk[2]:.3f} ms, ref "
                      f"{runs[('ref', wb, group, b, 'big')][2]:.3f} ms), "
                      f"K7 launches per call {big_row[3]}", flush=True)

    # serve_replicas on a subset: those rows of serve
    svc = _tunable_service(torch, cfg, bank, TunableConfig(
        budget=0.25, weight_bits=4, early_exit=True, group=16), False,
        "auto", data)
    sub = [K - 1, K // 4, K // 2]
    (whole, _), _ = k7_call("tunable serve", lambda: svc.serve(
        big, return_aux=True), K7[2], 16)
    (part, _), _ = k7_call("tunable serve_replicas",
                           lambda: svc.serve_replicas(sub, big,
                                                      return_aux=True),
                           K7[2], 16)
    check(np.array_equal(part, whole[sub]),
          "tunable: serve_replicas differs from those rows of serve")

    # member 0 as one machine: the reference benchmark's K = 1 curve
    # (predict_batch_pruned on the 1024 rows, analyze_pruned on the test
    # split), unpacked and packed
    from repro_torch.kernels import packing
    tm0 = tm_mod.TMState(bank[0])
    rt0 = tm_mod.init_runtime(cfg, device="cuda")
    order0 = svc.tuner.order[0]
    xs_u = torch.from_numpy(big).to("cuda")
    xs_p = packing.pack_bits(xs_u)
    te_u = torch.from_numpy(te_x).to("cuda")
    te_p = packing.pack_bits(te_u)
    te_yt = torch.from_numpy(te_y.astype(np.int32)).to("cuda")
    for b in BUDGETS:
        m = m_for_budget(b, J)
        sel = torch.from_numpy(np.ascontiguousarray(order0[:, :m]))
        what = f"K = 1 pruned budget {b}"
        pu, _ = k7_call(what, lambda: tm_mod.predict_batch_pruned(
            cfg, tm0, rt0, xs_u, sel), K7[0])
        pp, _ = k7_call(what, lambda: tm_mod.predict_batch_pruned(
            cfg, tm0, rt0, xs_p, sel), K7[1])
        au, _ = k7_call(what, lambda: acc_mod.analyze_pruned(
            cfg, tm0, rt0, te_u, te_yt, sel), K7[0])
        ap, _ = k7_call(what, lambda: acc_mod.analyze_pruned(
            cfg, tm0, rt0, te_p, te_yt, sel), K7[1])
        check(torch.equal(pu, pp) and torch.equal(au, ap),
              f"K = 1 pruned: packed differs from unpacked at budget {b}")
        if b == 1.0:
            full = tm_mod.predict_batch(cfg, tm0, rt0, xs_u)
            check(torch.equal(pu, full), "K = 1 pruned at budget 1.0 "
                  "differs from predict_batch")
        print(f"tunable K=1 member 0 budget={b} (M={m}): held-out acc "
              f"{float(au):.4f} (analyze_pruned)", flush=True)

    # save -> restore -> serve and -> one drained tick == never stopping
    import tempfile
    svc = _tunable_service(torch, cfg, bank, TunableConfig(
        budget=0.5, weight_bits=4, early_exit=True, group=16), True, "auto",
        data)
    rows = np.arange(K * 8).reshape(K, 8) % 200
    for i in range(8):
        svc.submit_rows(tr_x[rows[:, i]], tr_y[rows[:, i]])
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        t = time.perf_counter()
        svc.save(d)
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        other = TMService.restore(d, eval_x=tr_x, eval_y=tr_y, device="cuda")
        t_restore = time.perf_counter() - t
    def serve_big(s):
        return k7_call("tunable restored serve", lambda: s.serve(
            big, return_aux=True), K7[3], 16)[0][0]

    check(np.array_equal(serve_big(svc), serve_big(other)),
          "tunable: the restored service serves other predictions")
    r1, r2 = svc.tick(max_points=64), other.tick(max_points=64)
    check(not svc.buffered.any() and not other.buffered.any()
          and np.array_equal(r1.trained, r2.trained)
          and torch.equal(svc.ss.tm.ta_state, other.ss.tm.ta_state)
          and np.array_equal(svc.rng_keys, other.rng_keys)
          and np.array_equal(svc.steps, other.steps)
          and np.array_equal(serve_big(svc), serve_big(other)),
          "tunable: save -> restore -> tick differs from never stopping")
    print(f"tunable save {t_save * 1e3:.1f} ms, restore "
          f"{t_restore * 1e3:.1f} ms; restore -> serve and -> one drained "
          "tick == never stopping: True", flush=True)

    # the adapt rule under a deep queue: shed, then recover
    svc = _tunable_service(torch, cfg, bank, TunableConfig(
        budget=1.0, adapt=True, min_budget=0.125, high_water=32,
        low_water=4), False, "auto", data)
    for i in range(40):
        svc.submit_rows(tr_x[rows[:, i % 8]], tr_y[rows[:, i % 8]])
    traj = []
    svc.tick(max_points=1)
    traj.append(svc.tuner.budget)
    while svc.buffered.any() or svc.tuner.budget < 1.0:
        svc.tick()
        traj.append(svc.tuner.budget)
        check(len(traj) < 64, "tunable: the adapt rule never recovered")
    check(traj[0] == 0.5 and min(traj) < 1.0 and traj[-1] == 1.0,
          f"tunable: adapt trajectory {traj} did not shed and recover")
    print(f"tunable adapt: budget per tick {traj}", flush=True)
    launched = {k: v for k, v in counters(ce, fb).items() if k in K7}
    print(f"tunable K7 launches: {json.dumps(launched)} (expected "
          f"{json.dumps(expect)})", flush=True)
    check(expect[K7[0]] == expect[K7[1]] == 2 * len(BUDGETS),
          f"tunable: K = 1 member-0 launches {expect} != 2 a budget")
    check(launched == expect, "tunable: the phase's K7 launches differ from "
          "the sum of its calls' counts")
    check(all(v > 0 for v in launched.values()),
          "a K7 entry never launched on the tunable path")
    return launched


# The replica-axis mesh (phase ``mesh``): four slabs of the replica axis on
# one card (the port's counterpart of the reference's forced host devices),
# and on every card where there are several.
MESH_SLABS = 4
MESH_K = 256                    # the packed MNIST fleet, f = 784
MESH_TICKS = 2                  # resident ticks of MESH_CHUNK points
MESH_CHUNK = 8
MESH_AUTO_ACTIVE = (8, 8, 8, 24, 24)   # "auto": active replicas a round
MESH_TUNE_K = 16                # the unpacked tunable fleet (K7 on bytes)
MESH_ORDERINGS = 120            # the paper's sweep, a 2 x 2 grid
MESH_EPOCHS = 3
MESH_KERNELS = ("clause_counts_replicated", "clause_counts_batch_replicated",
                "clause_counts_batch_replicated_packed",
                "clause_counts_batch_pruned_replicated",
                "clause_counts_batch_pruned_replicated_packed",
                "feedback_plane_replicated")


def _mesh_fleet(torch, np, cfg, bank, mesh, resident, data, dev, timer):
    """The MNIST fleet's flow, sharded over ``mesh`` or not: every member's
    own stream through ``submit_rows`` and ``MESH_TICKS`` resident ticks
    (each timed by ``timer``), calibration, a shared 1024-row serve at the
    live budget 1.0 with vote weights and early exit, and a budgeted serve
    at 0.5 (both K7 on words) -- or, with ``resident="auto"``, the rounds
    of ``MESH_AUTO_ACTIVE`` active members and a ``serve_replicas`` (K6).
    Returns the service and its outputs."""
    from repro_torch.serve import (AdaptPolicy, ServiceConfig, TMService,
                                   TunableConfig)

    xs, ys, ev_x, ev_y, serve_x = data
    K = MESH_K
    auto = resident == "auto"
    ports = ({} if auto else dict(
        s=[FLEET_S[r % 4] for r in range(K)],
        T=[FLEET_T[(r // 4) % 4] for r in range(K)]))
    svc = TMService(cfg, bank, ServiceConfig(
        replicas=K, packed=True, buffer_capacity=64, chunk=MESH_CHUNK,
        ingress_block=MESH_CHUNK, seed=SEED, mesh=mesh, resident=resident,
        policy=AdaptPolicy(analyze_every=32),
        tunable=None if auto else TunableConfig(weight_bits=4,
                                                early_exit=True),
        **({"s": 3.0, "T": 15} if auto else ports)),
        eval_x=ev_x, eval_y=ev_y, device=dev)
    out = {}
    if auto:
        rng = np.random.default_rng(SEED + 11)
        traj = []
        for r, n in enumerate(MESH_AUTO_ACTIVE):
            mask = np.zeros(K, dtype=bool)
            mask[rng.choice(K, n, replace=False)] = True
            i = (r * 13) % len(xs)
            svc.submit_rows(xs[i], int(ys[i]), mask)
            svc.tick()
            traj.append(svc.n_resident)
        out["trajectory"] = traj
        sub = np.arange(0, K, 9)
        out["served"] = svc.serve_replicas(sub, serve_x[:256])
        return svc, out
    idx = (np.arange(len(xs))[None, :MESH_TICKS * MESH_CHUNK]
           + 7 * np.arange(K)[:, None]) % len(xs)
    ticks = []
    for t in range(MESH_TICKS):
        for i in range(t * MESH_CHUNK, (t + 1) * MESH_CHUNK):
            svc.submit_rows(xs[idx[:, i]], ys[idx[:, i]])
        with timer(ticks):
            svc.tick()
    out["tick_ms"] = ticks
    out["scores"] = svc.calibrate()
    out["served"] = svc.serve(serve_x)
    preds, aux = svc.serve(serve_x[:256], budget=0.5, return_aux=True)
    out.update(pruned=preds, evaluated=aux.evaluated)
    return svc, out


def _mesh_tunable_bytes(torch, np, cfg, bank, mesh, data, dev):
    """An unpacked K = 16 tunable fleet on random banks: one drained tick,
    calibrate, a budgeted, weighted, early-exit serve (K7 on bytes) and
    a plain serve (K4)."""
    from repro_torch.serve import ServiceConfig, TMService, TunableConfig

    xs, ys, ev_x, ev_y, serve_x = data
    K = MESH_TUNE_K
    svc = TMService(cfg, bank, ServiceConfig(
        replicas=K, buffer_capacity=16, chunk=8, seed=SEED + 1, mesh=mesh,
        s=3.0, T=15,
        tunable=TunableConfig(budget=0.5, weight_bits=4, early_exit=True)),
        eval_x=ev_x, eval_y=ev_y, device=dev)
    for i in range(8):
        svc.submit_rows(xs[i:i + K], ys[i:i + K])
    svc.tick(8)
    scores = svc.calibrate()
    preds, aux = svc.serve(serve_x[:256], budget=0.5, return_aux=True)
    return svc, dict(scores=scores, pruned=preds, evaluated=aux.evaluated,
                     plain=svc.serve(serve_x[:256]), acc=svc.analyze())


def _mesh_sweeps(torch, np, cfg, mesh, dev):
    """``CrossValRun.sweep`` on iris: the paper's 120 orderings over a
    2 x 2 grid (R = 480, slabs of 120: each reads its streams as they
    are) and 4 orderings over a 2-cell grid (R = 8, slabs of 2: one
    gathered stream row a replica)."""
    from repro_torch.data import blocks
    from repro_torch.eval.crossval import CrossValRun

    out = []
    for O, s_vals, epochs in ((MESH_ORDERINGS, (1.375, 3.0), MESH_EPOCHS),
                              (4, (1.375,), 2)):
        osets, _ = blocks.iris_paper_sets(n_orderings=O)
        res = CrossValRun(cfg, device=dev if mesh is None else None,
                          mesh=mesh).sweep(
            osets.offline_x, osets.offline_y, osets.validation_x,
            osets.validation_y, s_vals, (5, 15), n_epochs=epochs, seed=SEED)
        out.append(res)
    return out


def phase_mesh(torch, np, ce, fb, smi: str, dev: str = "cuda"):
    """The replica-axis mesh on the card: each sharded run below held
    bitwise (``torch.equal`` / ``np.array_equal``) to the same run without
    a mesh on the card, over ``MESH_SLABS`` slabs laid on card 0 (and, with
    more than one card, over a mesh of all of them):

    * the full-width MNIST fleet (f = 784, packed, K = 256, random banks,
      per-replica s and T): resident ticks, a shared serve, calibration
      and a budgeted serve (K7 on words); banks, rings, step counters,
      keys, history and predictions; then ``resident="auto"`` on sparse
      rounds: the logical fleet, the ``n_resident`` trajectory, the
      residency map and ``serve_replicas``;
    * ``CrossValRun(mesh).sweep`` on iris at 120 orderings over 2 x 2 and
      at 4 orderings over 2 cells (the gathered-stream path);
    * an unpacked tunable fleet (K7 on bytes, K4).

    Prints each replicated kernel's launches on the sharded runs alone
    (each must be > 0) and a resident tick's ms without a mesh and with
    the slabs on one card."""
    import contextlib

    from repro_torch.configs import tm_iris, tm_mnist
    from repro_torch.core import TMState
    from repro_torch.data import mnist
    from repro_torch.launch.mesh import Mesh, make_host_mesh

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def timer(into):
        sync()
        t = time.perf_counter()
        yield
        sync()
        into.append((time.perf_counter() - t) * 1e3)

    cfg = tm_mnist.CONFIG.tm
    xs, ys = mnist.load(seed=SEED + 21, n_points=1024)
    serve_x, _ = mnist.load(seed=SEED + 22, n_points=1024)
    data = (xs[:768], ys[:768], xs[768:], ys[768:], serve_x)
    rng = np.random.default_rng(SEED + 23)
    bank = TMState(torch.from_numpy(rng.integers(
        cfg.n_states - 2, cfg.n_states + 3,
        (cfg.max_classes, cfg.max_clauses, cfg.n_literals)).astype(np.int8)
    ).to(dev))
    meshes = [("4 slabs on one card", Mesh([dev] * MESH_SLABS, ("data",)))]
    if dev == "cuda" and torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards",
                       make_host_mesh()))
    launched = dict.fromkeys(MESH_KERNELS, 0)
    seconds = collections.defaultdict(float)    # wall s of each part

    def run(part, fn, *args, count=False):
        before = counters(ce, fb)
        sync()
        t = time.perf_counter()
        out = fn(*args)
        sync()
        seconds[("sharded " if count else "unsharded ") + part] += (
            time.perf_counter() - t)
        if count:
            after = counters(ce, fb)
            for k in MESH_KERNELS:
                launched[k] += after[k] - before[k]
        return out

    def sharded(part, fn, *args):
        return run(part, fn, *args, count=True)

    def same(a, b) -> bool:
        if torch.is_tensor(a):
            return torch.equal(a.cpu(), b.cpu())
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        return a.shape == b.shape and np.array_equal(a, b)

    def same_fleet(a, b) -> bool:
        sa, sb = a.ss, b.ss
        return (all(same(x, y) for x, y in zip(
                    (sa.tm.ta_state, *sa.buf, sa.step),
                    (sb.tm.ta_state, *sb.buf, sb.step)))
                and same(a.rng_keys, b.rng_keys) and same(a.steps, b.steps)
                and len(a.history) == len(b.history) and all(
                    same(x[1], y[1]) for x, y in zip(a.history, b.history)))

    t0 = time.perf_counter()
    iris_cfg = tm_iris.CONFIG.tm
    tbank = TMState(torch.from_numpy(rng.integers(
        cfg.n_states - 2, cfg.n_states + 3,
        (cfg.max_classes, cfg.max_clauses, cfg.n_literals)).astype(np.int8)
    ).to(dev))
    plain, p_out = run("fleet", _mesh_fleet, torch, np, cfg, bank, None,
                       None, data, dev, timer)
    plain_auto, pa_out = run("auto", _mesh_fleet, torch, np, cfg, bank,
                             None, "auto", data, dev, timer)
    p_sweeps = run("sweeps", _mesh_sweeps, torch, np, iris_cfg, None, dev)
    p_tune, pt_out = run("tunable", _mesh_tunable_bytes, torch, np, cfg,
                         tbank, None, data, dev)
    for label, mesh in meshes:
        slabs = len(mesh.devices.reshape(-1))
        shd, s_out = sharded("fleet", _mesh_fleet, torch, np, cfg, bank,
                             mesh, None, data, dev, timer)
        check(len(shd._slabs) == slabs, f"mesh {label}: fleet not sharded")
        check(same_fleet(plain, shd) and all(
                  same(p_out[k], s_out[k]) for k in
                  ("served", "scores", "pruned", "evaluated")),
              f"mesh {label}: the sharded MNIST fleet differs from the "
              "unsharded one")
        shd_a, sa_out = sharded("auto", _mesh_fleet, torch, np, cfg, bank,
                                mesh, "auto", data, dev, timer)
        check(pa_out["trajectory"] == sa_out["trajectory"]
              and same_fleet(plain_auto, shd_a)
              and same(plain_auto.resident, shd_a.resident)
              and same(plain_auto._res.slot_of, shd_a._res.slot_of)
              and same(pa_out["served"], sa_out["served"])
              and plain_auto.repartitions == shd_a.repartitions > 0,
              f"mesh {label}: the sharded auto-residency fleet differs "
              "from the unsharded one")
        sweeps = sharded("sweeps", _mesh_sweeps, torch, np, iris_cfg, mesh,
                         dev)
        check(all(same(a.val_accuracy, b.val_accuracy)
                  and same(a.mean_accuracy, b.mean_accuracy)
                  for a, b in zip(p_sweeps, sweeps)),
              f"mesh {label}: a sharded sweep differs from the unsharded "
              "one")
        tune, t_out = sharded("tunable", _mesh_tunable_bytes, torch, np,
                              cfg, tbank, mesh, data, dev)
        check(same_fleet(p_tune, tune) and all(
                  same(pt_out[k], t_out[k]) for k in pt_out),
              f"mesh {label}: the sharded tunable fleet differs from the "
              "unsharded one")
        print(f"mesh {label}: MNIST fleet K={MESH_K} f={cfg.n_features} "
              f"packed ({MESH_TICKS} resident ticks, serve, calibrate, K7 "
              f"serve), auto trajectory {sa_out['trajectory']}, sweeps R = "
              f"{[s.replicas for s in sweeps]}, tunable K={MESH_TUNE_K}: "
              "bitwise == unsharded: True", flush=True)
        if label.startswith("4 slabs"):
            tick_ms = (_median(p_out["tick_ms"]), _median(s_out["tick_ms"]))
    check(all(launched[k] > 0 for k in MESH_KERNELS),
          f"mesh: a replicated kernel never launched on the sharded path: "
          f"{launched}")
    print(f"mesh launches on the sharded runs: {json.dumps(launched)}",
          flush=True)
    print(f"mesh tick ms (K={MESH_K} f={cfg.n_features} packed, "
          f"{MESH_CHUNK} points a replica, median of {MESH_TICKS}): "
          f"unsharded {tick_ms[0]:.3f}, {MESH_SLABS} slabs on one card "
          f"{tick_ms[1]:.3f}; {smi}", flush=True)
    print(f"mesh phase body {time.perf_counter() - t0:.2f} s; by part: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()),
          flush=True)
    return launched


# Offers per producer in phase traffic: half the schedules' 256 (about
# 20-30 s of the script's wall), to make room for the paper's full-scale
# Fig 6-9 runs and the examples. The fault still lands (fault_at = 192 of
# the 512 points drained fleet-wide).
TRAFFIC_POINTS = 128


def phase_traffic(torch, np, ce, fb):
    """The traffic harness on the card: the iris service at the
    reference's traffic geometry (K = 4 producers, capacity 512, chunk
    32, ingress block 32, analysis every 64) with an adapting tuner at a
    budget of 0.5, offline-trained and calibrated; the steady and
    fault_injected
    schedules (TRAFFIC_POINTS offers per producer) run threaded, then a
    fresh twin replays each from one thread and must land on the same
    fingerprint."""
    from repro_torch.configs import tm_iris
    from repro_torch.core import init_state
    from repro_torch.data import iris
    from repro_torch.serve import (SCENARIOS, AdaptPolicy, ServiceConfig,
                                   TMService, TunableConfig, make_scripts,
                                   replay_single_caller, run_threaded)
    from repro_torch.serve.traffic import (fingerprint, fingerprints_equal,
                                           slo_summary)

    cfg = tm_iris.CONFIG.tm
    xs, ys = iris.load()
    K = 4

    def service():
        svc = TMService(cfg, init_state(cfg, device="cuda"), ServiceConfig(
            replicas=K, buffer_capacity=512, chunk=32, ingress_block=32,
            s=3.0, T=15, seed=0, policy=AdaptPolicy(analyze_every=64),
            # a live budget below 1 from the start: every serve probe runs
            # K7 under the producers' threads, and the queue rule may
            # shed it further
            tunable=TunableConfig(budget=0.5, adapt=True)),
            eval_x=xs, eval_y=ys, device="cuda")
        svc.offline_train(xs[:100], ys[:100], n_epochs=2)
        svc.calibrate()
        return svc

    for name in ("steady", "fault_injected"):
        sc = dataclasses.replace(SCENARIOS[name], points=TRAFFIC_POINTS)
        scripts = make_scripts(sc, xs, ys, cfg.max_classes, K, seed=0)
        live = service()
        before = counters(ce, fb)
        result = run_threaded(live, scripts, scenario=sc, pace=0.0)
        after = counters(ce, fb)
        twin = service()
        replay_single_caller(twin, scripts, result, scenario=sc)
        check(result.conserved(), f"traffic {name}: offers not conserved")
        check(fingerprints_equal(fingerprint(live), fingerprint(twin)),
              f"traffic {name}: the threaded run differs from its "
              "single-caller replay")
        if sc.fault_at is not None:
            check(result.fault_tick is not None
                  and bool(live.rt.ta_or_mask.any()),
                  f"traffic {name}: the fault never landed")
        s = slo_summary(result)
        k7 = sum(after[k] - before[k] for k in after if "pruned" in k)
        print(f"traffic {name} K={K} (tunable adapt, pace 0): "
              f"{s['offers']} offers, {s['probes']} probes, "
              f"{s['offers_per_s']:.1f} offers/s, serve p50 "
              f"{s['serve_p50_s'] * 1e3:.3f} ms p99 "
              f"{s['serve_p99_s'] * 1e3:.3f} ms, submit p99 "
              f"{s['submit_p99_s'] * 1e3:.3f} ms, {s['ticks']} ticks, "
              f"budget min {result.tick_budget.min()} max "
              f"{result.tick_budget.max()}, K7 launches {k7}, "
              f"rollbacks {s['rollbacks']}; replay fingerprint equal: True",
              flush=True)


# The residency paths (phase ``residency``): (name, config module, K,
# slots, rounds, active replicas a round, packed). Iris is the reference
# benchmark's largest row (benchmarks/residency.py ``residency_k4096``);
# MNIST the full-width machine (one 1,003,520-byte int8 bank each).
RES_PATHS = (("iris", "tm_iris", 4096, 64, 6, 32, False),
             ("mnist", "tm_mnist", 256, 32, 8, 16, True))
RES_WINDOWS = 7                 # timed windows a side, batched and sync
RES_AUTO_K, RES_AUTO_ROUNDS = 64, 24
RES_TUNE_K, RES_TUNE_R = 16, 4
RES_SAVE = (256, 16, 4, 32)     # K, slots, rounds before and after, active
RES_KERNELS = ("clause_counts_replicated", "clause_counts_batch_replicated",
               "clause_counts_batch_replicated_packed",
               "clause_counts_batch_pruned_replicated",
               "feedback_plane_replicated")


def _res_service(cfg, K, resident, bank=None, *, packed=False, batched=True,
                 tunable=None):
    """A drain-only residency service on the card: the reference
    benchmark's knobs (capacity 16, chunk 8, ingress block 8, s = 3.0,
    T = 15, analysis off)."""
    from repro_torch.core import init_state
    from repro_torch.serve import AdaptPolicy, ServiceConfig, TMService

    state = init_state(cfg, device="cuda") if bank is None else bank
    return TMService(cfg, state, ServiceConfig(
        replicas=K, buffer_capacity=16, chunk=8, ingress_block=8,
        packed=packed, s=3.0, T=15, seed=SEED, resident=resident,
        batched_moves=batched, policy=AdaptPolicy(analyze_every=10 ** 9),
        tunable=tunable), device="cuda")


def _res_drive(np, ce, fb, svc, others, twin, rounds, active, xs, ys,
               seed):
    """``rounds`` rounds of sparse traffic: ``active[r]`` random replicas
    each get one row, then ``svc`` and ``others`` tick and the always-
    resident ``twin`` ticks with budgets masked by ``svc``'s
    ``buffered > 0``. Returns (``svc``'s kernel launches, the drain steps
    the code implies: one K3 + K9 step a cohort of at most ``resident``
    replicas with rows, since each holds one row)."""
    rng = np.random.default_rng(seed)
    K = svc.n_replicas
    launched = dict.fromkeys(RES_KERNELS, 0)
    steps = 0
    for r in range(rounds):
        ids = rng.choice(K, size=active[r], replace=False)
        mask = np.zeros(K, dtype=bool)
        mask[ids] = True
        i = int(rng.integers(0, len(xs)))
        for s in [svc, *others] + ([twin] if twin else []):
            s.submit_rows(xs[i], int(ys[i]), mask)
        svc.flush()
        drive = svc.buffered > 0
        steps += -(-int(drive.sum()) // svc.n_resident)
        before = counters(ce, fb)
        svc.tick()
        after = counters(ce, fb)
        for k in RES_KERNELS:
            launched[k] += after[k] - before[k]
        for s in others:
            s.tick()
        if twin is not None:
            twin.tick(np.where(drive, twin.chunk, 0))
    return launched, steps


def _res_equal(torch, np, a, b) -> bool:
    """The logical fleets of two services (assembled banks, rings, step
    counters, keys) are bitwise equal."""
    sa, sb = a.ss, b.ss
    leaves = lambda s: (s.tm.ta_state, *s.buf, s.step)   # noqa: E731
    return (all(torch.equal(x, y) for x, y in zip(leaves(sa), leaves(sb)))
            and np.array_equal(a.rng_keys, b.rng_keys)
            and np.array_equal(a.steps, b.steps))


def _snapshot_bytes(svc) -> int:
    """Bytes of one replica's device state: bank, ring, step, key."""
    from repro_torch import tree as T

    return sum(a[0].numel() * a.element_size()
               for a in T.leaves((svc._ss, svc._keys)))


def _copy_ms(torch, np, nbytes: int) -> tuple[float, float, float]:
    """Median ms of one pinned H2D copy of ``nbytes``, one D2H copy, and
    one host copy between two pinned buffers (what an activation does
    to stage its snapshots)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    stage = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    on_host = []
    for _ in range(7):
        t = time.perf_counter()
        np.copyto(stage.numpy(), host.numpy())
        on_host.append((time.perf_counter() - t) * 1e3)
    on_host.sort()
    out = []
    for dst, src in ((dev, host), (host, dev)):
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        out.append(times[len(times) // 2])
    return out[0], out[1], on_host[len(on_host) // 2]


def _move_ms(torch, np, svc, cycles: int = 9) -> tuple[float, float, int]:
    """Explicit moves of a cohort of ``resident`` replicas (evict, then
    activate, ``cycles`` times): the median ms a replica for each, and
    the cohort. Each evicted snapshot must own pageable memory of its
    own (no view of the cohort's pinned batch stays in the store)."""
    from repro_torch import tree as T

    cohort = np.nonzero(svc.resident)[0][:svc.n_resident]
    t_evict, t_act = [], []
    for _ in range(cycles):
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc.evict(cohort)
        torch.cuda.synchronize()
        t_evict.append(time.perf_counter() - t)
        check(all(isinstance(a, np.generic) or a.flags.owndata
                  for r in cohort for a in T.leaves(svc._res.store[r])),
              "residency: an evicted snapshot is a view of its batch")
        t = time.perf_counter()
        svc.activate(cohort)
        torch.cuda.synchronize()
        t_act.append(time.perf_counter() - t)
    n = len(cohort)
    return _median(t_evict) / n * 1e3, _median(t_act) / n * 1e3, n


def _res_timed(torch, np, cfg, K, R, rounds, active, xs, ys, packed,
               bank):
    """A batched and a synchronous service (``batched_moves=False``) on the
    same traffic, each through 2 warm-up rounds, then ``RES_WINDOWS``
    windows a side of ``rounds`` rounds (submit + tick, ended by a
    synchronize), alternating b s s b b s ... so drift on the host falls
    on both sides: (batched service, sync service, [batched wall s a
    window], [sync wall s a window], [points trained a window]). Window i
    of either side trains the same traffic."""
    sides = {}
    for batched in (True, False):
        sides[batched] = (_res_service(cfg, K, R, bank, packed=packed,
                                       batched=batched),
                          np.random.default_rng(SEED + 1))

    def window(batched, n):
        svc, rng = sides[batched]
        done = int(svc.steps.sum())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            ids = rng.choice(K, size=active, replace=False)
            mask = np.zeros(K, dtype=bool)
            mask[ids] = True
            i = int(rng.integers(0, len(xs)))
            svc.submit_rows(xs[i], int(ys[i]), mask)
            svc.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return wall, int(svc.steps.sum()) - done

    window(True, 2)
    window(False, 2)
    walls = {True: [], False: []}
    pts = {True: [], False: []}
    for w in range(RES_WINDOWS):
        for batched in ((True, False) if w % 2 == 0 else (False, True)):
            wall, p = window(batched, rounds)
            walls[batched].append(wall)
            pts[batched].append(p)
    check(pts[True] == pts[False], "residency: timed windows trained "
          "different traffic")
    return (sides[True][0], sides[False][0], walls[True], walls[False],
            pts[True])


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def phase_residency(torch, np, ce, fb):
    """Host-spilled replica residency on the card, every path through
    ``TMService`` on "cuda" and held bitwise to an always-resident twin on
    the card driven with budgets masked by ``buffered > 0``:

    * iris at the reference benchmark's largest row (K = 4096 on 64 slots,
      6 rounds of 32 random active replicas) and MNIST at full width,
      packed (K = 256 on 32 slots, 8 rounds of 16): batched moves and the
      synchronous ones (``batched_moves=False``) against the twin and each
      other; ``serve_replicas`` of a subset against the twin's. Then each
      timed: trained points/s through submit + tick, batched and
      synchronous (``speedup_vs_percohort``), explicit evict and activate
      ms a replica, the move rate beside pinned copies of the same size;
    * ``resident="auto"`` (iris, K = 64, 24 rounds from dense to sparse):
      the ``n_resident`` trajectory and the re-partitions;
    * tunable serving under residency (OVERPROVISIONED, K = 16 on 4 slots,
      random banks): calibrate by cohort, ``serve_replicas`` at budget 1.0
      equal to the always-resident ``serve`` and at 0.25 to its budgeted
      serve, through K7 replicated;
    * save on the card, restore with ``resident="saved"`` and continue:
      equal to the fleet that never stopped.

    K3 + K9 must have launched once a drain step, K4 once a calibrate or
    unpacked serve cohort, K6 once a packed serve cohort and K7 replicated
    once a tunable serve cohort. Returns this phase's launches."""
    import importlib
    import tempfile

    from repro_torch import tree as T
    from repro_torch.configs import tm_mnist
    from repro_torch.core import TMState
    from repro_torch.data import iris, mnist
    from repro_torch.serve import TMService, TunableConfig

    zero_counters(ce, fb)
    want = dict.fromkeys(RES_KERNELS, 0)
    got = dict.fromkeys(RES_KERNELS, 0)

    def add(launched):
        for k in RES_KERNELS:
            got[k] += launched[k]

    def counted(fn):
        before = counters(ce, fb)
        out = fn()
        after = counters(ce, fb)
        add({k: after[k] - before[k] for k in RES_KERNELS})
        return out

    ix, iy = iris.load()
    mx, my = mnist.load(seed=SEED + 3, n_points=512)
    data = {"tm_iris": (ix, iy), "tm_mnist": (mx, my)}
    for name, mod, K, R, rounds, active, packed in RES_PATHS:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG.tm
        xs, ys = data[mod]
        bank = None
        if name == "mnist":
            rng = np.random.default_rng(SEED)
            bank = TMState(torch.from_numpy(rng.integers(
                cfg.n_states - 2, cfg.n_states + 3,
                (cfg.max_classes, cfg.max_clauses, cfg.n_literals)
            ).astype(np.int8)).to("cuda"))
        svc = _res_service(cfg, K, R, bank, packed=packed)
        sync = _res_service(cfg, K, R, bank, packed=packed, batched=False)
        twin = _res_service(cfg, K, None, bank, packed=packed)
        launched, steps = _res_drive(np, ce, fb, svc, [sync], twin, rounds,
                                     [active] * rounds, xs, ys, SEED)
        add(launched)
        want["clause_counts_replicated"] += steps
        want["feedback_plane_replicated"] += steps
        check(svc._res.evictions > 0, f"residency {name}: no eviction")
        check(_res_equal(torch, np, svc, twin),
              f"residency {name}: differs from the always-resident twin")
        check(_res_equal(torch, np, svc, sync),
              f"residency {name}: batched moves differ from synchronous")
        sub = np.random.default_rng(SEED + 2).choice(K, min(K, 4 * R),
                                                     replace=False)
        q = xs[:64]
        served = counted(lambda: svc.serve_replicas(sub, q))
        kname = ("clause_counts_batch_replicated_packed" if packed
                 else "clause_counts_batch_replicated")
        want[kname] += -(-len(sub) // R)
        check(np.array_equal(served, twin.serve_replicas(sub, q))
              and served.shape == (len(sub), len(q)) and served.min() >= 0
              and served.max() < cfg.max_classes,
              f"residency {name}: serve_replicas differs from the twin's")
        check(_res_equal(torch, np, svc, twin),
              f"residency {name}: serving moved the logical fleet")
        del sync, twin
        snap = _snapshot_bytes(svc)
        store_mb = sum(a.nbytes for snap in svc._res.store.values()
                       for a in T.leaves(snap)) / 2 ** 20
        # timed: batched and synchronous windows, alternating
        tb, ts, wall_b, wall_s, pts = _res_timed(
            torch, np, cfg, K, R, rounds, active, xs, ys, packed, bank)
        rate_b = [p / w for p, w in zip(pts, wall_b)]
        rate_s = [p / w for p, w in zip(pts, wall_s)]
        ratio = [s_ / b_ for s_, b_ in zip(wall_s, wall_b)]
        acts, evs = tb._res.activations, tb._res.evictions
        ev_ms, act_ms, n = _move_ms(torch, np, tb)
        ev_sync, act_sync, _ = _move_ms(torch, np, ts)
        # page-locked bytes the caching host allocator holds for live
        # tensors once the moves are done (before the copies below)
        pinned = (torch.cuda.host_memory_stats().get(
            "allocated_bytes.current", "not reported")
            if hasattr(torch.cuda, "host_memory_stats")
            else "not reported by this torch")
        h2d, d2h, hcopy = _copy_ms(torch, np, n * snap)
        gb = n * snap / 1e9
        print(f"residency {name} K={K} R={R} packed={packed}: "
              f"{RES_WINDOWS} windows a side of {rounds} rounds x {active} "
              f"active, {pts} points a window; points/s median "
              f"{_median(rate_b):.1f} (min {min(rate_b):.1f}, max "
              f"{max(rate_b):.1f}) batched, {_median(rate_s):.1f} (min "
              f"{min(rate_s):.1f}, max {max(rate_s):.1f}) sync; "
              f"speedup_vs_percohort median {_median(ratio):.3f} (min "
              f"{min(ratio):.3f}, max {max(ratio):.3f}; per window "
              f"{[round(r, 3) for r in ratio]}); "
              f"{acts} activations, {evs} evictions; snapshot {snap} bytes; "
              f"store {store_mb:.1f} MiB logical, pinned host bytes "
              f"allocated now {pinned}; "
              f"evict {ev_ms:.4f} ms/replica ({gb / (ev_ms * n / 1e3):.3f} "
              f"GB/s), activate {act_ms:.4f} ms/replica "
              f"({gb / (act_ms * n / 1e3):.3f} GB/s) on cohorts of {n} "
              f"(sync: evict {ev_sync:.4f}, activate {act_sync:.4f}); "
              f"pinned copy of {n * snap} bytes: H2D {h2d:.4f} ms "
              f"({gb / (h2d / 1e3):.3f} GB/s), D2H {d2h:.4f} ms "
              f"({gb / (d2h / 1e3):.3f} GB/s), host to host {hcopy:.4f} ms "
              f"({gb / (hcopy / 1e3):.3f} GB/s); bitwise == twin == sync: "
              "True", flush=True)
        del svc, tb, ts

    # auto: dense rounds grow the plane, sparse rounds shrink it
    cfg = importlib.import_module("repro_torch.configs.tm_iris").CONFIG.tm
    K = RES_AUTO_K
    auto = _res_service(cfg, K, "auto")
    twin = _res_service(cfg, K, None)
    traj = [auto.n_resident]
    half = RES_AUTO_ROUNDS // 2
    for n_active, seed in ((K, SEED), (1, SEED + 1)):
        for _ in range(half):
            launched, steps = _res_drive(np, ce, fb, auto, [], twin, 1,
                                         [n_active], ix, iy, seed)
            seed += 1
            add(launched)
            want["clause_counts_replicated"] += steps
            want["feedback_plane_replicated"] += steps
            traj.append(auto.n_resident)
    check(max(traj) > traj[0] and traj[-1] < max(traj),
          f"residency auto: the plane never grew and shrank ({traj})")
    check(_res_equal(torch, np, auto, twin),
          "residency auto: differs from the always-resident twin")
    print(f"residency auto K={K}: n_resident per round {traj}, "
          f"repartitions {auto.repartitions}, ewma_active "
          f"{auto._res.ewma_active:.4f}; bitwise == twin: True", flush=True)

    # tunable serving under residency, random banks
    cfg = tm_mnist.OVERPROVISIONED.tm
    K, R = RES_TUNE_K, RES_TUNE_R
    rng = np.random.default_rng(SEED + 4)
    banks = torch.from_numpy(rng.integers(
        1, 2 * cfg.n_states + 1,
        (K, cfg.max_classes, cfg.max_clauses, cfg.n_literals)).astype(
            np.int8)).to("cuda")
    tc = TunableConfig(budget=1.0)
    res = _res_service(cfg, K, R, TMState(banks.clone()), tunable=tc)
    full = _res_service(cfg, K, None, TMState(banks.clone()), tunable=tc)
    cal_x, cal_y = mx[:200], my[:200]
    scores = counted(lambda: res.calibrate(cal_x, cal_y))
    want["clause_counts_batch_replicated"] += -(-K // R)
    check(np.array_equal(scores, full.calibrate(cal_x, cal_y))
          and np.array_equal(res.tuner.order, full.tuner.order),
          "residency tunable: calibration differs from always-resident")
    big = mx[:256]
    for b, oracle in ((1.0, lambda: full.serve(big)),
                      (0.25, lambda: full.serve(big, budget=0.25))):
        t = time.perf_counter()
        preds = counted(lambda: res.serve_replicas(np.arange(K), big,
                                                   budget=b))
        ms = (time.perf_counter() - t) * 1e3
        want["clause_counts_batch_pruned_replicated"] += -(-K // R)
        check(np.array_equal(preds, oracle()),
              f"residency tunable: serve_replicas at budget {b} differs "
              "from the always-resident serve")
        print(f"residency tunable K={K} R={R} f={cfg.n_features} "
              f"J={cfg.max_clauses}: serve_replicas(all, {len(big)} rows, "
              f"budget {b}) {ms:.3f} ms with {res._res.activations} "
              f"activations so far; == always-resident serve: True",
              flush=True)

    # save on the card, restore as saved, continue
    cfg = importlib.import_module("repro_torch.configs.tm_iris").CONFIG.tm
    K, R, n_rounds, active = RES_SAVE
    svc = _res_service(cfg, K, R)
    launched, steps = _res_drive(np, ce, fb, svc, [], None, n_rounds,
                                 [active] * n_rounds, ix, iy, SEED + 5)
    add(launched)
    want["clause_counts_replicated"] += steps
    want["feedback_plane_replicated"] += steps
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        t = time.perf_counter()
        svc.save(d)
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        other = TMService.restore(d, device="cuda")
        t_restore = time.perf_counter() - t
    check(other.sc.resident == R and other.n_resident == R
          and _res_equal(torch, np, svc, other),
          "residency: the restored fleet differs from the saved one")
    launched, steps = _res_drive(np, ce, fb, svc, [other], None, n_rounds,
                                 [active] * n_rounds, ix, iy, SEED + 6)
    add(launched)
    want["clause_counts_replicated"] += steps
    want["feedback_plane_replicated"] += steps
    check(_res_equal(torch, np, svc, other),
          "residency: save -> restore -> continue differs from never "
          "stopping")
    print(f"residency save K={K} R={R}: save {t_save * 1e3:.1f} ms, restore "
          f"{t_restore * 1e3:.1f} ms; restore as saved -> {n_rounds} rounds "
          "== never stopping: True", flush=True)

    total = {k: v for k, v in counters(ce, fb).items() if k in RES_KERNELS}
    print(f"residency launches: {json.dumps(got)} (expected "
          f"{json.dumps(want)}; the phase's, twins included: "
          f"{json.dumps(total)})", flush=True)
    check(got == want, "residency: kernel launches differ from the counts "
          "the code implies")
    check(all(v > 0 for v in got.values()),
          "a kernel of the residency path never launched")
    return got


def phase_one_launch(torch, np, ce):
    """torch.profiler over one call each, at the main path's shapes, of K2
    (640 x 1568, B = 1024), K = 1 K7 on bytes (C = 10, J = 128, M = 32,
    sel on the card), K5 (640 x 50 words, B = 1024) and K = 1 K7 on words
    (the same selection): each must run exactly one CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import packing

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 16)
    cj, L = FULL
    inc = torch.from_numpy(rng.random((cj, L)) < 0.05).to(dev)
    x = torch.from_numpy(rng.random((1024, L // 2)) < 0.5).to(dev)
    lits = torch.cat([x, ~x], -1)
    bank = torch.from_numpy(rng.random((PRUNED_C, PRUNED_J, L)) < 0.05).to(
        dev)
    inc_w, bank_w = (packing.pack_include(inc, L // 2),
                     packing.pack_include(bank, L // 2))
    lit_w = packing.pack_literals(x)
    sel = torch.from_numpy(np.stack([rng.permutation(PRUNED_J)[:32]
                                     for _ in range(PRUNED_C)]).astype(
        np.int32)).to(dev)
    for name, fn in (
            ("clause_counts_batch", lambda: ce.clause_counts_batch(inc, lits)),
            ("clause_counts_batch_pruned",
             lambda: ce.clause_counts_batch_pruned(bank, sel, lits)),
            ("clause_counts_batch_packed",
             lambda: ce.clause_counts_batch_packed(inc_w, lit_w)),
            ("clause_counts_batch_pruned_packed",
             lambda: ce.clause_counts_batch_pruned_packed(bank_w, sel,
                                                          lit_w))):
        fn()                         # warm: the build and lazy set-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"profile one call of {name}: CUDA kernels {kernels}",
              flush=True)
        check(sum(n for _, n in kernels) == 1,
              f"{name}: one call ran {kernels}, not one CUDA kernel")


def phase_time_words(torch, np, ce):
    """K5 (640 x 50 words, B = 1024), K6 (R = 16 on D = 1, B = 150) and the
    two K7 word entries at the OVERPROVISIONED serve (C = 10, J = 128,
    f = 784, B = 1024; R = 1, and R = 16 on D = 1) at M = 32 and 128: each
    held to its plain version on the timed operands (replica by replica),
    then timed. Used by ``--kernels-from``: it calls only wrappers whose
    names and signatures every tree since the packed slice shares."""
    from repro_torch.kernels import packing

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 19)
    C, J, f, B = PRUNED_C, PRUNED_J, 784, 1024
    recs = []

    def bank(R, rows):
        return packing.pack_include(torch.from_numpy(
            rng.random((R, rows, 2 * f)) < 0.05).to(dev), f)

    def lits(n):
        return packing.pack_literals(torch.from_numpy(
            rng.random((1, n, f)) < 0.5).to(dev))

    def timed(name, shape, args, plain_args=None):
        got = getattr(ce, name)(*args)
        want = getattr(ce, name + "_plain")(*(plain_args or args))
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{name} differs from its plain version at {shape}")
        ms = time_ms(torch, lambda: getattr(ce, name)(*args))
        print(f"time {name} ({shape}): kernel {ms:.5f} ms", flush=True)
        recs.append({"name": name, "shape": shape, "ms": ms})

    timed("clause_counts_batch_packed", "CJ=640 W=50 B=1024",
          (bank(1, 640)[0], lits(B)[0]))
    inc6, lit6 = bank(FLEET_K, 640), lits(B_ANALYSIS)
    got = ce.clause_counts_batch_replicated_packed(inc6, lit6)
    want = by_replica(torch, ce.clause_counts_batch_replicated_packed_plain,
                      inc6, lit6)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K6 differs from its plain version")
    ms = time_ms(torch, lambda: ce.clause_counts_batch_replicated_packed(
        inc6, lit6))
    print(f"time clause_counts_batch_replicated_packed (R={FLEET_K} D=1 "
          f"CJ=640 W=50 B={B_ANALYSIS}): kernel {ms:.5f} ms", flush=True)
    recs.append({"name": "clause_counts_batch_replicated_packed",
                 "shape": f"R={FLEET_K} B={B_ANALYSIS}", "ms": ms})
    lit = lits(B)
    for name, R in (("clause_counts_batch_pruned_packed", 1),
                    ("clause_counts_batch_pruned_replicated_packed",
                     FLEET_K)):
        inc = bank(R, C * J).reshape(R, C, J, -1)
        for M in (J // 4, J):
            sel = torch.from_numpy(np.stack([np.stack([
                rng.permutation(J)[:M] for _ in range(C)])
                for _ in range(R)]).astype(np.int32)).to(dev)
            if R == 1:
                timed(name, f"R=1 M={M}", (inc[0], sel[0], lit[0]))
                continue
            fn = getattr(ce, name)
            got = fn(inc, sel, lit)
            want = by_replica(torch, getattr(ce, name + "_plain"), inc, lit,
                              sel)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name} differs from its plain version at R={R} M={M}")
            ms = time_ms(torch, lambda: fn(inc, sel, lit))
            print(f"time {name} (R={R} D=1 C={C} J={J} M={M} f={f} B={B}): "
                  f"kernel {ms:.5f} ms", flush=True)
            recs.append({"name": name, "shape": f"R={R} M={M}", "ms": ms})
    return recs


def phase_time_serves(torch, np):
    """End-to-end serves on random banks made from the seed (the serve's
    work does not depend on what the bank learned): the packed K = 1
    TMService at f = 784 (configs/tm_mnist.CONFIG) serving 1024 rows, and
    the packed K = 16 tunable fleet on the OVERPROVISIONED preset (J =
    128), calibrated on 200 rows, serving 1024 rows at budgets 1 and
    0.125 without early exit. Host clock around each serve to numpy, the
    median of 5 after one warm serve. Used by ``--kernels-from``."""
    from repro_torch.configs import tm_mnist
    from repro_torch.core.tm import TMState
    from repro_torch.data import mnist
    from repro_torch.serve import ServiceConfig, TMService, TunableConfig

    rng = np.random.default_rng(SEED + 20)
    big, _ = mnist.load(seed=SEED + 9, n_points=1024)
    tr_x, tr_y, _, _ = mnist.splits(n_train=200, n_test=8, seed=SEED)

    def median_ms(fn):
        fn()
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)[2]

    def random_bank(cfg, lead):
        return torch.from_numpy(rng.integers(
            1, 2 * cfg.n_states + 1, lead + (cfg.max_classes,
                                              cfg.max_clauses,
                                              2 * cfg.n_features)).astype(
            np.int8)).to("cuda")

    cfg = tm_mnist.CONFIG.tm
    svc = TMService(cfg, TMState(random_bank(cfg, ())), ServiceConfig(
        replicas=1, packed=True, seed=SEED), eval_x=tr_x, eval_y=tr_y,
        device="cuda")
    ms = {"packed K=1 serve(1024)": median_ms(lambda: svc.serve(big))}
    cfg = tm_mnist.OVERPROVISIONED.tm
    svc = _tunable_service(torch, cfg, random_bank(cfg, (FLEET_K,)),
                           TunableConfig(budget=1.0), True, "auto",
                           (tr_x, tr_y))
    for b in (1.0, 0.125):
        ms[f"packed K=16 tunable serve(1024) budget={b}"] = median_ms(
            lambda: svc.serve(big, budget=b))
    for k, v in ms.items():
        print(f"serve {k}: {v:.3f} ms (median of 5, host clock)", flush=True)
    return ms


def phase_time_pruned_bytes(torch, np, ce):
    """The two K7 byte entries at the OVERPROVISIONED serve (C = 10, J =
    128, f = 784, B = 1024; R = 1, and R = 16 on D = 1) at M = 32 and 128:
    each held to its plain version on the timed operands, then timed.
    Used by ``--kernels-from``, whose trees may predate the full phase."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 15)
    C, J, f, B = PRUNED_C, PRUNED_J, 784, 1024
    recs = []
    for name, R in (("clause_counts_batch_pruned", 1),
                    ("clause_counts_batch_pruned_replicated", FLEET_K)):
        inc = torch.from_numpy(rng.random((R, C, J, 2 * f)) < 0.05).to(dev)
        x = torch.from_numpy(rng.random((1, B, f)) < 0.5).to(dev)
        lits = torch.cat([x, ~x], -1)
        for M in (J // 4, J):
            sel = torch.from_numpy(np.stack([np.stack([
                rng.permutation(J)[:M] for _ in range(C)])
                for _ in range(R)]).astype(np.int32)).to(dev)
            args = (inc[0], sel[0], lits[0]) if R == 1 else (inc, sel, lits)
            got = getattr(ce, name)(*args)
            want = getattr(ce, name + "_plain")(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{name} differs from its plain version at R={R} M={M}")
            ms = time_ms(torch, lambda: getattr(ce, name)(*args))
            b_ms, b_by = bound(*k7_bytes_work(R, C, M, f, B), INT8_OPS_PER_S)
            print(f"time {name} (R={R} D=1 C={C} J={J} M={M} f={f} B={B}): "
                  f"kernel {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by})",
                  flush=True)
            recs.append({"name": name, "shape": f"R={R} M={M}", "ms": ms,
                         "bound_ms": b_ms})
    return recs


# The LM serving path (phase ``lm``): gemma3-1b at full width and depth
# (26 layers, d_model 1152, vocab 262,144, 5:1 local:global, window 512),
# random weights from SEED. 4 prompts of 1024 tokens take the streaming-
# softmax prefill (S > attn_chunk 512) and 64 new tokens wrap the local
# windows. Float32 checks: max |a - b| <= LM_TOL * max |b|, TF32 off.
LM_ARCH = "gemma3_1b"
LM_B, LM_PROMPT, LM_NEW = 4, 1024, 64
LM_TOL = 1e-4
LM_PROFILE_STEPS = 8
LM_OTHER = ("granite_8b", "phi3_medium_14b", "qwen25_14b", "musicgen_medium")
LM_OTHER_B, LM_OTHER_S = 2, 128
LM_DENSE_S = 520                # a forward on the dense path past the window


def _lm_close(torch, got, want, what: str) -> float:
    """max |got - want| / max |want| (float32, on the CPU); fails above
    LM_TOL."""
    got, want = got.float().cpu(), want.float().cpu()
    check(bool(torch.isfinite(got).all()), f"lm {what}: non-finite values")
    err = ((got - want).abs().max() / want.abs().max()).item()
    check(err <= LM_TOL, f"lm {what}: max|d| / max|ref| {err:.3e} > "
          f"{LM_TOL}")
    return err


def _lm_tokens_match(torch, np, got, want, decision, what: str) -> int:
    """Greedy tokens equal, or each row's first difference at a near-tie
    of the reference's logits (``decision(step)`` [B, V]). Returns the
    rows that differed."""
    rows = 0
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        rows += 1
        i = int(diff[0])
        vals = decision(i)[b].float()
        top2 = torch.topk(vals, 2).values
        gap = (top2[0] - top2[1]).item()
        check(gap <= LM_TOL * vals.abs().max().item(),
              f"lm {what}: row {b} step {i}: {got[b, i]} vs {want[b, i]} at "
              f"a top-2 gap of {gap}")
    return rows


def _lm_model(torch, cfg, seed: int, dev):
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(seed)
    return P.materialize(transformer.model_specs(cfg), gen, torch.float32,
                         device=dev)


def _lm_prefill_decode_vs_forward(torch, np, cfg, tree, B, S, dev, what):
    """decode(prefill(x[:S]), x[S]) against forward(x[:S+1])[S]."""
    from repro_torch.models.transformer import Transformer

    m = Transformer(cfg, tree, device=dev)
    rng = np.random.default_rng(SEED)
    if cfg.embeds_input:
        x = torch.from_numpy(0.05 * rng.standard_normal(
            (B, S + 1, cfg.d_model))).float().to(dev)
        full, pre, step = {"embeds": x}, {"embeds": x[:, :S]}, {
            "embeds": x[:, S:S + 1]}
    else:
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (B, S + 1))).to(dev)
        full, pre, step = {"tokens": t}, {"tokens": t[:, :S]}, {
            "token": t[:, S:S + 1]}
    want = m(full)[0][:, S].clone()
    _, cache = m.prefill(pre, S + 16)
    got, _ = m.decode_step({**step, "pos": S}, cache)
    return _lm_close(torch, got, want, what)


def phase_lm(torch, np):
    """The dense LM serving path on the card (no CUDA kernel of its own:
    plain PyTorch ops).

    1. gemma3-1b, full width and depth, bfloat16 compute: ``materialize``
       on the card, ``Engine(batch_slots=4, max_seq=1088).generate`` of 4
       x 1024-token prompts, 64 new tokens; prefill ms, decode ms a step
       (median of CUDA-event windows), tokens/s, peak memory, and
       torch.profiler over 8 decode steps (launches a step, idle share);
    2. the same model at float32 compute: prefill -> decode == forward at
       position 1024, and ``generate`` of 8 tokens equal to a full-forward
       greedy re-run;
    3. granite-8b, phi3-medium-14b, qwen2.5-14b and musicgen-medium at
       full width, depth cut to one pattern repetition: prefill -> decode
       == forward, float32;
    4. gemma3-1b at full width cut to 6 layers: the same parameters on
       the card and on the CPU, forward (dense path, 520 tokens), prefill
       (flash path, 1024 tokens) logits and caches, and one decode step.
       At float64 compute the two agree within LM_TOL. At float32 they
       need not: at this random init (a stacked leaf's fan-in is the
       super-block count) the attention scores are large, so the
       last-bit differences of two summation orders move the
       softmax of rows whose top scores lie a few units apart, and some
       positions' logits move by more than LM_TOL of the range (the phase
       prints how many). So the float32 results are each held
       to the float64 evaluation: the card's error may not exceed
       max(LM_TOL, 4 x the CPU's)."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine, EngineConfig

    dev = torch.device("cuda")
    cfg = configs.get_config(LM_ARCH)
    check(cfg.compute_dtype == "bfloat16", "gemma3-1b computes in bf16")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    tree = _lm_model(torch, cfg, SEED, dev)
    torch.cuda.synchronize()
    print(f"lm {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.param_count():,} parameters "
          f"materialized on the card in {time.perf_counter() - t:.2f} s "
          f"({torch.cuda.memory_allocated() - base:,} bytes, float32)",
          flush=True)

    # 1. the user's call, its parts and a profile window
    _lm_serve(torch, np, "lm", cfg, tree, LM_NEW, _smi())
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_B, LM_PROMPT)).astype(np.int32)

    # 2. exactness at full width, float32 compute (TF32 off)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    err = _lm_prefill_decode_vs_forward(
        torch, np, cfg32, tree, 2, LM_PROMPT, dev,
        f"{cfg.arch_id} f32 prefill -> decode vs forward")
    n8, S8 = 8, LM_PROMPT
    eng32 = Engine(cfg32, tree, EngineConfig(max_seq=S8 + n8, batch_slots=2),
                   device=dev)
    p8 = prompts[:2]
    got = eng32.generate(p8, n8)
    seq = torch.from_numpy(p8.astype(np.int64)).to(dev)
    want, steps = [], []
    for _ in range(n8):
        last = eng32.model({"tokens": seq})[0][:, -1]
        steps.append(last.cpu())
        nxt = torch.argmax(last, dim=-1)
        want.append(nxt.cpu().numpy().astype(np.int32))
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    want = np.stack(want, axis=1)
    rows = _lm_tokens_match(torch, np, got, want, lambda i: steps[i],
                            "f32 generate vs forward re-run")
    print(f"lm {cfg.arch_id} f32: prefill({LM_PROMPT}, flash) -> decode vs "
          f"forward({LM_PROMPT + 1}, dense) max|d|/max|ref| {err:.3e}; "
          f"generate {n8} tokens == full-forward greedy re-run "
          f"({rows} rows differed at a near-tie)", flush=True)
    del eng32, tree
    torch.cuda.empty_cache()

    # 3. the other dense archs at full width, one pattern repetition
    for arch in LM_OTHER:
        full = configs.get_config(arch)
        c = dataclasses.replace(full, n_layers=len(full.layer_pattern),
                                compute_dtype="float32")
        tr = _lm_model(torch, c, SEED, dev)
        err = _lm_prefill_decode_vs_forward(
            torch, np, c, tr, LM_OTHER_B, LM_OTHER_S, dev,
            f"{arch} prefill -> decode vs forward")
        print(f"lm {c.arch_id} (reduced: n_layers {full.n_layers} -> "
              f"{c.n_layers}; d_model {c.d_model}, vocab {c.vocab_size}, "
              f"f32): prefill({LM_OTHER_S}) -> decode vs forward "
              f"max|d|/max|ref| {err:.3e}", flush=True)
        del tr
        torch.cuda.empty_cache()

    # 4. card against CPU, gemma3-1b at full width cut to 6 layers
    c32 = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern),
                              compute_dtype="float32")
    tr = _lm_model(torch, c32, SEED + 1, dev)
    tr_cpu = T.map(lambda t: t.cpu(), tr)
    td = torch.from_numpy(rng.integers(0, c32.vocab_size, (1, LM_DENSE_S)))
    t1k = torch.from_numpy(rng.integers(0, c32.vocab_size,
                                        (1, LM_PROMPT + 1)))

    def outputs(c, tree, where):
        """forward(LM_DENSE_S) logits, prefill(LM_PROMPT) logits, its
        caches, one decode step's logits: all on the CPU, as float64."""
        m = Transformer(c, tree, device=where)
        fwd = m({"tokens": td.to(where)})[0]
        pre, cache = m.prefill({"tokens": t1k[:, :LM_PROMPT].to(where)},
                               LM_PROMPT + 8)
        dec, _ = m.decode_step({"token": t1k[:, LM_PROMPT:].to(where),
                                "pos": LM_PROMPT}, cache)
        return [x.double().cpu() for x in (fwd, pre, dec, *T.leaves(cache))]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    c64 = dataclasses.replace(c32, compute_dtype="float64")
    gpu64, cpu64 = outputs(c64, tr, dev), outputs(c64, tr_cpu, "cpu")
    gpu32, cpu32 = outputs(c32, tr, dev), outputs(c32, tr_cpu, "cpu")
    names = ["forward", "prefill", "decode"] + [
        f"cache {i}" for i in range(len(gpu64) - 3)]
    e64 = [rel(g, c) for g, c in zip(gpu64, cpu64)]
    check(max(e64) <= LM_TOL, f"lm card vs cpu, float64: {max(e64):.3e}")
    e32 = [rel(g, c) for g, c in zip(gpu32, cpu32)]
    card = [rel(g, t) for g, t in zip(gpu32, cpu64)]
    host = [rel(c, t) for c, t in zip(cpu32, cpu64)]
    for n, a, b in zip(names, card, host):
        check(a <= max(LM_TOL, 4 * b),
              f"lm card vs cpu, float32 {n}: the card's error against the "
              f"float64 evaluation {a:.3e} > max(LM_TOL, 4 x the CPU's "
              f"{b:.3e})")
    rows = ((gpu32[0] - cpu32[0]).abs().amax(-1)
            > LM_TOL * cpu32[0].abs().max())
    print(f"lm {c32.arch_id} card vs CPU (reduced: n_layers {cfg.n_layers} "
          f"-> {c32.n_layers}; forward({LM_DENSE_S}), prefill({LM_PROMPT}) "
          f"and its {len(gpu64) - 3} caches, one decode step): float64 "
          f"max|d|/max|cpu| {max(e64):.3e}; float32 "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names[:3], e32[:3]))
          + f", caches {max(e32[3:]):.3e} ({int(rows.sum())} of "
          f"{LM_DENSE_S} forward positions beyond {LM_TOL}); float32 "
          "against float64, card / CPU: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, a, b in
                      zip(names[:3], card[:3], host[:3]))
          + f", caches {max(card[3:]):.3e} / {max(host[3:]):.3e}",
          flush=True)
    del tr, tr_cpu
    torch.cuda.empty_cache()
    _lm_silu_cost(torch, np, _smi())


# What ``layers.silu``'s bf16 sigmoid (XLA's op-by-op expansion,
# ``layers._LogisticBF16``) costs a dense swiglu model against one
# ``torch.sigmoid``: granite-8b at full width, depth cut to one layer.
SILU_ARCH = "granite_8b"
SILU_DECODE_STEPS, SILU_TRAIN_STEPS = 16, 3


def _lm_silu_cost(torch, np, smi) -> None:
    """granite-8b (one layer, full width, bf16 compute) with the port's
    ``layers.silu`` and with ``x * torch.sigmoid(x)`` swapped in, in the
    order plain, port, port, plain: decode at B = LM_B after a
    LM_PROMPT-token prefill (launches a step over LM_PROFILE_STEPS steps;
    ms a step, CUDA events, median of SILU_DECODE_STEPS), and AdamW train
    steps at B LM_TRAIN_B x S LM_TRAIN_S (ms a step, median of
    SILU_TRAIN_STEPS after a warm step; peak memory). The decode tokens of
    the two variants are not compared: they round differently."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic
    from repro_torch.models import layers
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import train_step as TS

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get_config(SILU_ARCH), n_layers=1)
    check(cfg.act == "swiglu" and cfg.compute_dtype == "bfloat16",
          f"{SILU_ARCH}: a bf16 swiglu model")
    tree = _lm_model(torch, cfg, SEED + 11, dev)
    m = Transformer(cfg, tree, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_B, LM_PROMPT))).to(dev)
    max_seq = LM_PROMPT + 2 + LM_PROFILE_STEPS + SILU_DECODE_STEPS
    tc = TS.TrainConfig()
    state = {"s": TS.init_state(tc, T.map(torch.clone, tree))}
    data = synthetic.token_batches(
        cfg, ShapeConfig("silu", LM_TRAIN_S, LM_TRAIN_B, "train"), seed=SEED)
    port = layers.silu

    def plain(x):
        return x * torch.sigmoid(x)

    def run(silu) -> dict:
        layers.silu = silu
        try:
            logits, cache = m.prefill({"tokens": toks}, max_seq)
            box = {"tok": torch.argmax(logits, -1), "pos": LM_PROMPT,
                   "cache": cache}

            def one():
                lg, box["cache"] = m.decode_step(
                    {"token": box["tok"][:, None], "pos": box["pos"]},
                    box["cache"])
                box["tok"] = torch.argmax(lg, dim=-1)
                box["pos"] += 1

            one()                                    # warm
            pr = _profile(torch, one, LM_PROFILE_STEPS, "silu decode")
            dec = []
            for _ in range(SILU_DECODE_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                one()
                b.record()
                b.synchronize()
                dec.append(a.elapsed_time(b))
            del box, cache, logits
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = []
            for i in range(SILU_TRAIN_STEPS + 1):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state["s"], met = TS.train_step(cfg, tc, state["s"],
                                                next(data), donate=True)
                b.record()
                b.synchronize()
                check(bool(torch.isfinite(met["loss"])),
                      f"silu cost {SILU_ARCH}: non-finite loss")
                if i:
                    tr.append(a.elapsed_time(b))
            return {"launches": pr["launches"],
                    "decode": sorted(dec)[len(dec) // 2],
                    "train": sorted(tr)[len(tr) // 2],
                    "peak": torch.cuda.max_memory_allocated()}
        finally:
            layers.silu = port

    runs = [("plain", run(plain)), ("port", run(port)),
            ("port", run(port)), ("plain", run(plain))]
    print(f"lm silu cost {cfg.arch_id} (reduced: n_layers "
          f"{_full_layers(cfg)} -> 1) [{smi}] bf16, decode B {LM_B} after "
          f"{LM_PROMPT} tokens, train B {LM_TRAIN_B} x S {LM_TRAIN_S} "
          f"(remat {cfg.remat}, AdamW); x * torch.sigmoid(x) = plain, "
          "layers.silu = port: " + "; ".join(
              f"{k}: decode {r['decode']:.3f} ms a step, {r['launches']:.1f}"
              f" launches a step, train {r['train']:.3f} ms a step, peak "
              f"{r['peak']:,} bytes" for k, r in runs), flush=True)
    del state, m, tree
    torch.cuda.empty_cache()


# lm_train: gemma3-1b at full width and depth, bf16, remat "dots", AdamW
# (float32 moments), B = 4 x S = 1024 from data.synthetic, 8 timed steps.
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 1024, 8
LM_TRAIN_PROFILE_STEPS = 2
LM_SGD_DECREASE = 1e-3          # the descent step's first-order decrease
LM_CUT_LAYERS = 6               # the card-against-CPU train step
LM_LAUNCH_LAYERS = 6            # the launcher's save and resume (PR 24)


def _per_layer_init(torch, cfg, tree: dict) -> dict:
    """``tree`` with every stacked fan-in-scaled leaf rescaled to its one
    layer's fan-in (std scale / sqrt(d), as the unstacked layers are), in
    place of ``materialize``'s super-block count: at one super-block that
    count gives std 1 weights, and float32 gradients there are
    ill-conditioned (tests/test_torch_lm_train.py)."""
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    def walk(spec, node):
        if isinstance(spec, P.PSpec):
            if spec.init == "normal" and spec.axes[0] == "layers":
                node.mul_((spec.shape[0] / spec.shape[1]) ** 0.5)
            return
        for k in spec:
            walk(spec[k], node[k])

    walk(transformer.model_specs(cfg), tree)
    return tree


def _rel_tree(torch, got, want) -> float:
    """max over leaves of max |got - want| / max |want| (float64), on the
    card where either leaf is there (the CPU's leaf goes over in its own
    dtype: the same numbers, without a pass over the host's memory)."""
    from repro_torch import tree as T

    out = 0.0
    for a, b in zip(T.leaves(got), T.leaves(want)):
        dev = a.device if a.device.type == "cuda" else b.device
        a, b = a.detach().to(dev).double(), b.detach().to(dev).double()
        out = max(out, ((a - b).abs().max() / b.abs().max()).item())
        del a, b
    return out


def _lm_train_launcher(torch, np, cfg) -> None:
    """``python -m repro_torch.launch.train --full`` as a user runs it, at
    full width, depth cut to LM_LAUNCH_LAYERS (``--layers``; PR 24, for
    the script's time): 2 steps with a checkpoint of the whole state
    (parameters and moments, through the host) at step 2, then a restart
    with ``--steps 3`` that resumes from it (``restore_tensors``) and runs
    the third step."""
    import os
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt_mod

    ck = tempfile.mkdtemp(prefix="lm_train_ckpt_")
    args = ["--arch", cfg.arch_id, "--full", "--layers",
            str(LM_LAUNCH_LAYERS), "--batch", str(LM_TRAIN_B),
            "--seq", str(LM_TRAIN_S), "--ckpt-every", "2", "--ckpt-dir", ck,
            "--seed", str(SEED)]
    try:
        t = time.perf_counter()
        state, rep = launch_train.main(args + ["--steps", "2"])
        first = time.perf_counter() - t
        check(rep.steps_run == 2 and ckpt_mod.latest_step(ck) == 2
              and all(np.isfinite(rep.losses)),
              f"lm_train launcher: {rep}")
        del state
        torch.cuda.empty_cache()
        nbytes = sum(f.stat().st_size for f in os.scandir(
            os.path.join(ck, "step_000000002")))
        t = time.perf_counter()
        state, rep2 = launch_train.main(args + ["--steps", "3"])
        second = time.perf_counter() - t
        check(rep2.steps_run == 1 and int(state.opt.step) == 3
              and state.opt.step.is_cuda and rep2.restores == 0
              and all(np.isfinite(rep2.losses)),
              f"lm_train launcher resume: {rep2}")
        del state
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"lm_train launcher {cfg.arch_id} --full --layers "
          f"{LM_LAUNCH_LAYERS} (reduced: n_layers {cfg.n_layers} -> "
          f"{LM_LAUNCH_LAYERS}; B {LM_TRAIN_B} x S "
          f"{LM_TRAIN_S}): 2 steps and a {nbytes:,}-byte checkpoint in "
          f"{first:.2f} s (losses "
          + ", ".join(f"{x:.6f}" for x in rep.losses)
          + f"); the restart resumed at step 2 and ran step 3 in "
          f"{second:.2f} s (loss {rep2.losses[0]:.6f})", flush=True)


def phase_lm_train(torch, np):
    """The dense LM training path on the card (no CUDA kernel of its own:
    plain PyTorch ops, the streaming-softmax backward included).

    0. the launcher, ``launch.train.main([... "--full"])``: train, save the
       whole state, restart and resume (``_lm_train_launcher``);

    1. gemma3-1b, full width and depth, bf16 compute, ``remat="dots"``:
       gradients with remat equal (``torch.equal``) to those without, on
       one batch, with each pass's peak memory;
    2. 8 ``train_step(donate=True)`` calls (AdamW, float32 moments) on
       ``data.synthetic`` batches: step ms (CUDA events, median of steps
       3-8), tokens/s, peak memory, the losses and gradient norms (finite);
       one step without remat for its peak; torch.profiler over 2 steps
       (launches a step, idle share, top device ops);
    3. one plain SGD step at float32 compute lowers the loss on the same
       batch (tests/test_models_smoke.py's descent check), full width,
       with a step whose first-order decrease is LM_SGD_DECREASE;
    4. the streaming-softmax backward on the card against the CPU at
       gemma3's head shape, S = 1024, GLOBAL and LOCAL: float64 within
       LM_TOL, float32 each against float64, the card's error at most
       max(LM_TOL, 4 x the CPU's);
    5. one ``train_step`` of gemma3-1b at full width cut to 6 layers, B =
       1, S = 1024, on the card and on the CPU from the same
       state (drawn with each layer's fan-in): the loss, gradient norm,
       parameters and moments, under the same rule (the CPU's float32
       step run only where the card's misses float64 by more than
       LM_TOL)."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic
    from repro_torch.models import layers, transformer
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as TS

    dev = torch.device("cuda")
    cfg = configs.get_config(LM_ARCH)
    check(cfg.remat == "dots" and cfg.compute_dtype == "bfloat16",
          "gemma3-1b trains in bf16 with remat dots")
    tc = TS.TrainConfig()
    torch.cuda.empty_cache()
    _lm_train_launcher(torch, np, cfg)
    tree = _lm_model(torch, cfg, SEED, dev)
    state = TS.init_state(tc, tree)
    del tree
    shape = ShapeConfig("lm_train", LM_TRAIN_S, LM_TRAIN_B, "train")
    data = synthetic.token_batches(cfg, shape, seed=SEED)
    batches = [next(data) for _ in range(LM_TRAIN_STEPS + 2
                                         + LM_TRAIN_PROFILE_STEPS)]
    state_bytes = sum(t.numel() * t.element_size() for t in
                      T.leaves(state.params) + T.leaves(state.opt.mu)
                      + T.leaves(state.opt.nu))
    tokens = LM_TRAIN_B * LM_TRAIN_S

    # 1. remat: the same bits, less memory
    def grads(c):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _, g = TS.grad_fn(c, tc, state.params, batches[0])
        torch.cuda.synchronize()
        return loss, g, torch.cuda.max_memory_allocated()

    no_remat = dataclasses.replace(cfg, remat="none")
    l_dots, g_dots, pk_dots = grads(cfg)
    l_none, g_none, pk_none = grads(no_remat)
    same = torch.equal(l_dots, l_none) and all(
        torch.equal(a, b) for a, b in zip(T.leaves(g_dots), T.leaves(g_none)))
    check(same, "lm_train: gradients with remat dots differ from those "
          "without")
    del g_dots, g_none

    # 2. the training steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, norms = [], [], []
    for i in range(LM_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = TS.train_step(cfg, tc, state, batches[i], donate=True)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"lm_train: non-finite losses {losses} or norms {norms}")
    check(int(state.opt.step) == LM_TRAIN_STEPS, "lm_train: step counter")
    torch.cuda.reset_peak_memory_stats()
    state, m = TS.train_step(no_remat, tc, state, batches[LM_TRAIN_STEPS],
                             donate=True)
    torch.cuda.synchronize()
    peak_none = torch.cuda.max_memory_allocated()
    check(np.isfinite(m["loss"].item()), "lm_train: no-remat step")
    timed_ms = sorted(step_ms[2:])
    med = (timed_ms[len(timed_ms) // 2 - 1] + timed_ms[len(timed_ms) // 2]) / 2
    print(f"lm_train {cfg.arch_id} (bf16, remat dots, AdamW float32 moments, "
          f"B {LM_TRAIN_B} x S {LM_TRAIN_S}): step {med:.3f} ms (median of "
          f"steps 3-{LM_TRAIN_STEPS}: "
          + ", ".join(f"{x:.3f}" for x in step_ms[2:])
          + f"; step 1 {step_ms[0]:.3f}, step 2 {step_ms[1]:.3f}), "
          f"{tokens / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak:,} bytes over the steps ({state_bytes:,} of them the "
          f"parameters and moments), {peak_none:,} for a step without remat;"
          f" gradient pass alone {pk_dots:,} (dots) / {pk_none:,} (none), "
          "the gradients equal bit for bit", flush=True)
    print("lm_train losses: " + ", ".join(f"{x:.6f}" for x in losses)
          + "; grad norms: " + ", ".join(f"{x:.6f}" for x in norms),
          flush=True)

    box = {"state": state, "i": 0}

    def one():
        box["state"], _ = TS.train_step(
            cfg, tc, box["state"],
            batches[LM_TRAIN_STEPS + 1 + box["i"]], donate=True)
        box["i"] += 1

    pr = _profile(torch, one, LM_TRAIN_PROFILE_STEPS, "lm_train")
    state = box.pop("state")
    print(f"profile lm_train ({LM_TRAIN_PROFILE_STEPS} steps, bf16, remat "
          f"dots): wall {pr['wall']:.3f} ms, device busy {pr['busy']:.3f} "
          f"ms, idle share {pr['idle']:.4f}, launches {pr['launches']:.1f} a"
          f" step (device ops {pr['ops']:.1f} a step); top: {pr['top']}",
          flush=True)

    # where a step's time goes: the gradient pass, the optimizer, and the
    # float32 cross-entropy over the [B, S, V] logits alone (forward and
    # backward), each between CUDA events
    def ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out

    batch = batches[LM_TRAIN_STEPS + 1]
    t_grad, (_, _, g) = ms(lambda: TS.grad_fn(cfg, tc, state.params, batch))
    t_opt, _ = ms(lambda: opt_mod.apply(tc.opt, state.opt, state.params, g,
                                        donate=True))
    del g
    logits = torch.randn((LM_TRAIN_B, LM_TRAIN_S, cfg.vocab_size),
                         device=dev, requires_grad=True)
    toks = TS.batch_on(batch, dev)["tokens"]

    def ce():
        lse = torch.logsumexp(logits[:, :-1], dim=-1)
        gold = torch.gather(logits[:, :-1], -1,
                            toks[:, 1:, None].long())[..., 0]
        return torch.autograd.grad((lse - gold).mean(), logits)

    ms(ce)
    t_ce, _ = ms(ce)
    del logits
    print(f"lm_train step parts (CUDA events, one call each): gradient pass "
          f"{t_grad:.3f} ms (of it the float32 cross-entropy alone, forward "
          f"and backward over [{LM_TRAIN_B}, {LM_TRAIN_S}, {cfg.vocab_size}]"
          f" logits: {t_ce:.3f} ms), optimizer {t_opt:.3f} ms (clip + "
          f"AdamW over {len(T.leaves(state.params))} leaves)", flush=True)

    # 3. one plain SGD step lowers the loss (float32 compute, full width).
    # tests/test_models_smoke.py steps 0.005 x the gradient at smoke width
    # (gradient norms 17-62); at full width the norm is 100-450 and that
    # step leaves the linear regime (on an H100 it raised the loss 12.6459
    # -> 12.6578). So the step is eta = LM_SGD_DECREASE / |g|^2,
    # whose first-order decrease eta |g|^2 is LM_SGD_DECREASE nats; the
    # loss must fall (the curvature along g takes part of that decrease).
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = batches[0]
    loss, _, g = TS.grad_fn(c32, tc, state.params, batch)
    gsq = sum(torch.square(x).sum() for x in T.leaves(g)).item()
    eta = LM_SGD_DECREASE / gsq
    moved = T.map(lambda p, d: p - eta * d, state.params, g)
    del g
    with torch.no_grad():
        loss2 = transformer.loss_fn(
            c32, moved, TS.batch_on(batch, dev))[0].item()
    del moved
    drop = loss.item() - loss2
    check(drop > 0, f"lm_train: one SGD step of {eta:.3e} (first-order "
          f"decrease {LM_SGD_DECREASE}) moves the loss {loss.item()} -> "
          f"{loss2}")
    print(f"lm_train SGD descent (float32, full width, |g| "
          f"{gsq ** 0.5:.3f}, step {eta:.3e}): loss {loss.item():.6f} -> "
          f"{loss2:.6f}, a decrease of {drop:.6f} against "
          f"{LM_SGD_DECREASE} to first order", flush=True)
    del state
    torch.cuda.empty_cache()

    # 4. the streaming-softmax backward, card against CPU
    rng = np.random.default_rng(SEED)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []
    for window in (None, cfg.sliding_window):
        q, do = (torch.from_numpy(rng.standard_normal((1, LM_TRAIN_S, hq, dh)))
                 for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((1, LM_TRAIN_S, hkv, dh)))
                for _ in range(2))

        def bwd(dtype, where):
            xs = [x.to(dtype).to(where).requires_grad_() for x in (q, k, v)]
            out = layers._Flash.apply(*xs, window, cfg.attn_chunk)
            return [out.detach()] + list(torch.autograd.grad(
                out, xs, do.to(dtype).to(where)))

        g64, c64 = bwd(torch.float64, dev), bwd(torch.float64, "cpu")
        g32, h32 = bwd(torch.float32, dev), bwd(torch.float32, "cpu")
        names = ["out", "dq", "dk", "dv"]
        e64 = [_rel_tree(torch, {"x": a}, {"x": b}) for a, b in zip(g64, c64)]
        check(max(e64) <= LM_TOL, f"lm_train flash backward card vs cpu "
              f"float64: {max(e64):.3e}")
        card = [_rel_tree(torch, {"x": a}, {"x": b}) for a, b in zip(g32, c64)]
        host = [_rel_tree(torch, {"x": a}, {"x": b}) for a, b in zip(h32, c64)]
        for nme, a, b in zip(names, card, host):
            check(a <= max(LM_TOL, 4 * b), f"lm_train flash backward "
                  f"{window} float32 {nme}: card {a:.3e} > max(LM_TOL, 4 x "
                  f"cpu {b:.3e})")
        rows.append(f"{'LOCAL ' + str(window) if window else 'GLOBAL'}: "
                    f"float64 {max(e64):.3e}; float32 against float64, "
                    "card / CPU: " + ", ".join(
                        f"{nme} {a:.3e} / {b:.3e}"
                        for nme, a, b in zip(names, card, host)))
    print(f"lm_train flash backward card vs CPU (1 x {LM_TRAIN_S}, {hq} "
          f"heads of {dh}, {hkv} kv head, chunk {cfg.attn_chunk}): "
          + "; ".join(rows), flush=True)

    # 5. one train step, card against CPU, 6 layers at full width
    c6 = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS,
                             compute_dtype="float32")
    tree = _per_layer_init(torch, c6, _lm_model(torch, c6, SEED + 2, dev))
    tree_cpu = T.map(lambda t: t.cpu(), tree)
    tok = rng.integers(0, c6.vocab_size, (1, LM_TRAIN_S)).astype(np.int32)

    def step(dtype, params):
        c = dataclasses.replace(c6, compute_dtype=dtype)
        st, m = TS.train_step(c, tc, TS.init_state(tc, params),
                              {"tokens": tok})
        return {"loss": {"x": m["loss"]}, "grad_norm": {"x": m["grad_norm"]},
                "params": st.params, "mu": st.opt.mu, "nu": st.opt.nu}

    out64 = (step("float64", tree), step("float64", tree_cpu))
    e64 = {k: _rel_tree(torch, out64[0][k], out64[1][k]) for k in out64[0]}
    check(max(e64.values()) <= LM_TOL, f"lm_train step card vs cpu, "
          f"float64: {e64}")
    truth = out64[1]
    card = {k: _rel_tree(torch, v, truth[k])
            for k, v in step("float32", tree).items()}
    # the CPU's float32 step is needed only where the card's float32 step
    # misses the float64 one by more than LM_TOL (as _lmx_train_card_vs_cpu)
    host = ({k: _rel_tree(torch, v, truth[k]) for k, v in
             step("float32", tree_cpu).items()}
            if max(card.values()) > LM_TOL else None)
    for k in truth if host is not None else ():
        check(card[k] <= max(LM_TOL, 4 * host[k]), f"lm_train step card vs "
              f"cpu, float32 {k}: card {card[k]:.3e} > max(LM_TOL, 4 x cpu "
              f"{host[k]:.3e})")
    print(f"lm_train {c6.arch_id} train step card vs CPU (reduced: n_layers "
          f"{cfg.n_layers} -> {c6.n_layers}, B 1 x S {LM_TRAIN_S}, each "
          f"layer's fan-in; AdamW): float64 max|d|/max|cpu| "
          + ", ".join(f"{k} {v:.3e}" for k, v in e64.items())
          + "; float32 against float64, card / CPU: "
          + ", ".join(f"{k} {card[k]:.3e} / "
                      + ("-" if host is None else f"{host[k]:.3e}")
                      for k in truth)
          + (" (the card within LM_TOL: the CPU's float32 step not run)"
             if host is None else ""), flush=True)


# lm_moe_ssd: the MoE FFN and the SSD block served on the card (no CUDA
# kernel of their own: plain PyTorch ops), bf16, B = 4 x 1024-token
# prompts through Engine.generate. (arch, layers or None for all, the
# parameters' dtype, new tokens): arctic-480b's one layer at full width
# is 14.07 B parameters, whose float32 masters and bf16 copies (84.4 GB)
# would not fit the card, so it is drawn in bf16 (28.1 GB).
# serving depth cut to hold the script's time (PR 24): olmoe 16 -> 4,
# mamba2 48 -> 12 layers
LMX_SERVE = (("olmoe_1b_7b", 4, "float32", 64),
             ("mamba2_780m", 12, "float32", 64),
             ("arctic_480b", 1, "bfloat16", 16))
LMX_CUT, LMX_CPU_S = 2, 256     # the card-against-CPU depth and prompt
LMX_TOL_BF16 = 3e-2
# lm_moe_ssd_train: (arch, layers or None); olmoe-1b-7b's float32
# parameters and AdamW moments are 83.0 GB at full depth, 22.6 GB at 4
# of its 16 layers.
LMX_TRAIN = (("mamba2_780m", 12), ("olmoe_1b_7b", 4))   # mamba2 48 -> 12
LMX_TRAIN_STEPS, LMX_TRAIN_PROFILE_STEPS = 8, 2
# the train step against the CPU: olmoe at one layer (its float64 CPU step
# is most of this phase's time; routing and the expert gradients are at
# full width all the same), mamba2 at LMX_CUT
LMX_TRAIN_CPU = (("olmoe_1b_7b", 1), ("mamba2_780m", LMX_CUT))


def _profile(torch, fn, n: int, what: str) -> dict:
    """torch.profiler over ``n`` calls of ``fn``: wall ms, device busy ms,
    idle share, launches and device ops a call, the top device ops.

    It traces the CUDA activity alone (the runtime's launch calls and the
    device's kernels and copies). Tracing the CPU's operators as well
    counts the same launches and device time, but summarising such a trace
    takes tens of seconds for a few thousand launches a step, and the
    tracing lengthens the wall, which overstates the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    ka = prof.key_averages()
    devk = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in devk) / 1e3
    launches = sum(e.count for e in ka
                   if e.key.startswith("cudaLaunchKernel")
                   or e.key.startswith("cuLaunchKernel"))
    check(busy > 0, f"{what} profile: no device time traced")
    top = sorted(devk, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall": wall, "busy": busy, "idle": 1.0 - busy / wall,
            "launches": launches / n,
            "ops": sum(e.count for e in devk) / n,
            "top": "; ".join(f"{e.key[:50]} x{e.count} "
                             f"{e.self_device_time_total / 1e3:.3f} ms"
                             for e in top)}


class _Routes:
    """Records every ``moe.route`` call's routing (on the host) while
    active: the slots dropped by capacity, and the integers themselves."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        route = self.route = self.moe.route

        def recorded(cfg, p, xt):
            r = route(cfg, p, xt)
            self.calls.append((xt.detach(), p["router"],
                               [x.cpu() for x in r[:3]]))
            return r

        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def dropped(self) -> tuple[int, int]:
        return (sum(int((~k).sum()) for _, _, (_, _, k) in self.calls),
                sum(k.numel() for _, _, (_, _, k) in self.calls))


def _events_ms(torch, fn, reps: int = 5) -> float:
    """Median ms of ``reps`` calls of ``fn`` between CUDA events (after a
    warm call): launches and gaps included, as the eager path runs."""
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[len(out) // 2]


def _lmx_split(torch, cfg, compute, T_tokens: int) -> dict:
    """One layer of the MoE FFN or the SSD block timed by its parts at
    ``T_tokens`` tokens (B = LM_B rows), on the model's layer-0 compute
    weights: the whole block, and for MoE the router (``route``), the
    expert products over the capacity buffers (the three einsums and
    the activation) and, by difference, the dispatch scatter and the
    combine gather (less arctic's dense MLP, timed alone); for SSD the
    in/out projections and, by difference, the conv and the chunked scan
    (``ssd_forward``) or the recurrent step (``ssd_decode_step``)."""
    from repro_torch import tree as T
    from repro_torch.models import layers, moe, ssm

    dev = torch.device("cuda")
    cd = layers.compute_dtype(cfg)
    S = T_tokens // LM_B
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((LM_B, S, cfg.d_model), generator=g, device=dev,
                    dtype=torch.float32).to(cd)
    out = {}
    with torch.inference_mode():
        if cfg.moe is not None:
            p = T.map(lambda t: t[0], compute["blocks"]["pos0"]["ffn"])
            m = cfg.moe
            C = moe.capacity(cfg, T_tokens)
            xt = x.reshape(1, T_tokens, cfg.d_model)
            buf = torch.randn((1, m.n_experts, C, cfg.d_model), generator=g,
                              device=dev, dtype=torch.float32).to(cd)

            def experts():
                a = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
                u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
                return torch.einsum("gecf,efd->gecd", layers.silu(a) * u,
                                    p["w_down"])

            out["block"] = _events_ms(torch, lambda: moe.moe_ffn(cfg, p, x))
            out["route"] = _events_ms(torch, lambda: moe.route(cfg, p, xt))
            out["experts"] = _events_ms(torch, experts)
            out["dense"] = (_events_ms(torch, lambda: layers.mlp(
                cfg, p["dense"], xt)) if m.dense_residual else 0.0)
            out["dispatch+combine"] = (out["block"] - out["route"]
                                       - out["experts"] - out["dense"])
        else:
            p = T.map(lambda t: t[0], compute["blocks"]["pos0"]["mamba"])
            di = cfg.ssm.expand * cfg.d_model
            y = torch.randn((LM_B, S, di), generator=g, device=dev,
                            dtype=torch.float32).to(cd)
            out["proj"] = _events_ms(torch, lambda: (
                x @ p["in_proj"], y @ p["out_proj"]))
            if S == 1:
                st = ssm.init_state(cfg, LM_B, device=dev)
                st = st._replace(conv=st.conv.to(cd))
                out["block"] = _events_ms(
                    torch, lambda: ssm.ssd_decode_step(cfg, p, x, st))
            else:
                out["block"] = _events_ms(
                    torch, lambda: ssm.ssd_forward(cfg, p, x))
            out["conv+scan"] = out["block"] - out["proj"]
    return out


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _generate(torch, np, eng, prompts, new, extra):
    """``eng.generate(prompts, new)``; for a vlm (``extra`` holds its
    ``cross_embeds``), which ``generate`` refuses, the same greedy loop on
    ``Transformer.prefill`` with them, then ``decode_step``, the tokens
    kept on the card until the end."""
    if not extra:
        return eng.generate(prompts, new)
    m = eng.model
    toks = torch.from_numpy(prompts.astype(np.int64)).to(m.device)
    logits, cache = m.prefill({"tokens": toks, **extra}, eng.ec.max_seq)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for i in range(1, new):
        logits, cache = m.decode_step({"token": tok[:, None],
                                       "pos": prompts.shape[1] + i - 1},
                                      cache)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


def _lm_serve(torch, np, label, cfg, tree, new, smi, extra=None) -> None:
    """``cfg`` served at bf16 on the card through ``Engine.generate`` of
    LM_B x LM_PROMPT-token prompts and ``new`` tokens (twice: the first
    call pays cuBLAS's set-up; a vlm through ``_generate`` with the
    ``cross_embeds`` in ``extra``): the tokens checked (shape,
    vocabulary, repeatable, equal to a prefill's and the decode steps'
    greedy tokens), prefill ms (median of 3), decode ms a step (CUDA
    events, median), tokens/s, peak memory, a torch.profiler window of
    LM_PROFILE_STEPS decode steps; for MoE the slots dropped by capacity
    at prefill and at one decode step, and one layer's time split into
    its parts: MoE and SSD (``_lmx_split``), RG-LRU and CROSS
    (``_lmr_split``)."""
    from repro_torch.configs.base import CROSS, RGLRU
    from repro_torch import tree as T
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine, EngineConfig

    dev = torch.device("cuda")
    check(cfg.compute_dtype == "bfloat16", f"{cfg.arch_id} computes in bf16")
    max_seq = LM_PROMPT + new
    before = torch.cuda.memory_allocated()
    eng = Engine(cfg, tree, EngineConfig(max_seq=max_seq, batch_slots=LM_B),
                 device=dev)
    print(f"{label} {cfg.arch_id} compute-dtype copies: "
          f"{torch.cuda.memory_allocated() - before:,} bytes", flush=True)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size,
                           (LM_B, LM_PROMPT)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    walls, outs = [], []
    extra = extra or {}
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(_generate(torch, np, eng, prompts, new, extra))
        walls.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    out = outs[1]
    what = f"{label} {cfg.arch_id}"
    check(out.shape == (LM_B, new) and out.dtype == np.int32,
          f"{what} generate: shape {out.shape} {out.dtype}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{what} generate: a token outside the vocabulary")
    check(np.array_equal(outs[0], outs[1]), f"{what} generate repeats")

    m = eng.model
    toks = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    pre_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = m.prefill({"tokens": toks, **extra}, max_seq)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{what} prefill: non-finite")
    tok = torch.argmax(logits, dim=-1)
    check(np.array_equal(tok.cpu().numpy(), out[:, 0]),
          f"{what} prefill's greedy token differs from generate's")
    step_ms = []
    for i in range(1, new):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = m.decode_step({"token": tok[:, None],
                                       "pos": LM_PROMPT + i - 1}, cache)
        tok = torch.argmax(logits, dim=-1)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    check(np.array_equal(tok.cpu().numpy(), out[:, -1]),
          f"{what} decode steps' last token differs from generate's")
    pre, step = sorted(pre_ms)[1], sorted(step_ms)[len(step_ms) // 2]
    wbytes = sum(x.numel() * x.element_size() for x in T.leaves(m.compute))

    # the slots the capacity dropped, then the profile window
    with _Routes(moe) as rt:
        logits, cache = m.prefill({"tokens": toks, **extra}, max_seq)
    pre_drop = rt.dropped()
    tok = torch.argmax(logits, dim=-1)
    with _Routes(moe) as rt:
        logits, cache = m.decode_step({"token": tok[:, None],
                                       "pos": LM_PROMPT}, cache)
    dec_drop = rt.dropped()
    state = {"tok": torch.argmax(logits, dim=-1), "pos": LM_PROMPT + 1,
             "cache": cache}

    def one():
        lg, state["cache"] = m.decode_step(
            {"token": state["tok"][:, None], "pos": state["pos"]},
            state["cache"])
        state["tok"] = torch.argmax(lg, dim=-1)
        state["pos"] += 1

    one()                        # warm
    n = min(LM_PROFILE_STEPS, max_seq - state["pos"])
    pr = _profile(torch, one, n, f"{what} decode")
    cut = ("" if cfg.n_layers == _full_layers(cfg) else
           f" (reduced: n_layers {_full_layers(cfg)} -> {cfg.n_layers})")
    drops = ("" if cfg.moe is None else
             f"; slots dropped by capacity: prefill {pre_drop[0]:,} of "
             f"{pre_drop[1]:,} (C = {moe.capacity(cfg, LM_B * LM_PROMPT)}"
             f" a layer), one decode step {dec_drop[0]:,} of "
             f"{dec_drop[1]:,} (C = {moe.capacity(cfg, LM_B)})")
    print(f"{label} serve {cfg.arch_id}{cut} [{smi}] generate {LM_B} x "
          f"{LM_PROMPT} + {new} tokens (bf16, greedy): "
          f"{walls[1] * 1e3:.3f} ms ({LM_B * new / walls[1]:.1f} tokens/s;"
          f" first call {walls[0] * 1e3:.3f} ms); prefill {pre:.3f} ms "
          f"(median of 3: {', '.join(f'{x:.3f}' for x in pre_ms)}); decode "
          f"{step:.3f} ms a step (median of {len(step_ms)}, min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); peak memory "
          f"{peak:,} bytes; decode bound {wbytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms (the {wbytes:,} bytes of compute weights read once){drops}",
          flush=True)
    rc = RGLRU in cfg.layer_pattern or CROSS in cfg.layer_pattern
    if rc or cfg.moe is not None or cfg.ssm is not None:
        for k, t_ms, tokens in (("prefill", pre, LM_B * LM_PROMPT),
                                ("decode", step, LM_B)):
            if rc:
                parts = _lmr_split(torch, cfg, m.compute, tokens,
                                   extra.get("cross_embeds"))
                what_of = "; ".join(
                    f"{kind} x {n} layers = {parts[kind] * n:.3f} ms"
                    for kind, n in collections.Counter(
                        cfg.layer_kinds).items())
            else:
                parts = _lmx_split(torch, cfg, m.compute, tokens)
                what_of = (f"x {cfg.n_layers} layers = "
                           f"{parts['block'] * cfg.n_layers:.3f} ms")
            print(f"{label} split {cfg.arch_id} {k} (one layer, CUDA "
                  "events, median of 5): " + ", ".join(
                      f"{p} {v:.3f} ms" for p, v in parts.items())
                  + f"; {what_of} of the {t_ms:.3f} ms {k}", flush=True)
    print(f"profile {label} {cfg.arch_id} decode ({n} steps, bf16): wall "
          f"{pr['wall']:.3f} ms, device busy {pr['busy']:.3f} ms, idle share"
          f" {pr['idle']:.4f}, launches {pr['launches']:.1f} a step (device"
          f" ops {pr['ops']:.1f} a step); top: {pr['top']}", flush=True)
    del eng, m, cache, logits, state
    torch.cuda.empty_cache()


def _full_layers(cfg) -> int:
    from repro_torch import configs

    return configs.get_config(cfg.arch_id).n_layers


def _lmx_outputs(torch, cfg, tree, toks, where, S):
    """forward(S) logits, prefill(S) logits, its cache leaves and one
    decode step's logits, as float64 on the CPU; with every router call's
    routing (a ``_Routes``)."""
    from repro_torch import tree as T
    from repro_torch.models import moe
    from repro_torch.models.transformer import Transformer

    m = Transformer(cfg, tree, device=where)
    with _Routes(moe) as rt:
        fwd = m({"tokens": toks[:, :S].to(where)})[0]
        pre, cache = m.prefill({"tokens": toks[:, :S].to(where)}, S + 8)
        dec, _ = m.decode_step({"token": toks[:, S:S + 1].to(where),
                                "pos": S}, cache)
    out = [x.double().cpu() for x in (fwd, pre, dec, *T.leaves(cache))]
    del m, cache
    return out, rt


def _lmx_card_vs_cpu(torch, np, arch) -> None:
    """One arch at full width, depth cut, B = 1, S = LMX_CPU_S: forward,
    prefill (logits and caches) and one decode step on the card and on the
    CPU from the same parameters (each layer's fan-in). olmoe and mamba2
    at LMX_CUT layers: float64 within LM_TOL, the MoE routing (expert_idx,
    pos, keep) of every router call equal as integers, and float32 each
    against float64 (the card's error at most max(LM_TOL, 4 x the
    CPU's)); mamba2's prefill -> decode against a forward over S + chunk
    tokens on the card. arctic at one layer with bf16 parameters and
    compute (float32 copies of its 14.07 B parameters would not fit),
    within LMX_TOL_BF16 where both devices route a token alike, and its
    routing equal as integers at float64 on the recorded router
    inputs."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.models import moe
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    full = configs.get_config(arch)
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, full.vocab_size,
                                         (1, LMX_CPU_S + full.ssm.chunk
                                          if full.ssm else LMX_CPU_S + 1)))
    S = LMX_CPU_S

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    if arch == "arctic_480b":
        cfg = dataclasses.replace(full, n_layers=1)
        gen = torch.Generator(device=dev).manual_seed(SEED + 4)
        tree = _per_layer_init(torch, cfg, P.materialize(
            transformer.model_specs(cfg), gen, torch.bfloat16, device=dev))
        card, rg = _lmx_outputs(torch, cfg, tree, toks, dev, S)
        tree = T.map(lambda t: t.cpu(), tree)
        torch.cuda.empty_cache()
        host, rc = _lmx_outputs(torch, cfg, tree, toks, "cpu", S)
        check(len(rg.calls) == len(rc.calls) == 3, "router calls")
        # a token whose expert set or kept slots differ between the
        # devices (a bf16 near-tie) moves that token's output (one layer)
        # and, through the capacity, later tokens' in those experts: the
        # outputs are compared where both devices route a token alike
        alike = []
        for (_, _, a), (_, _, b) in zip(rg.calls, rc.calls):
            same = ((torch.sort(a[0], -1).values
                     == torch.sort(b[0], -1).values).all(-1)
                    & (a[2] == b[2]).all(-1))[0]
            alike.append(same)
        errs = {"forward": rel(card[0][0, alike[0]], host[0][0, alike[0]])}
        if bool(alike[1][-1]):
            errs["prefill"] = rel(card[1], host[1])
        if bool(alike[2][-1]):
            errs["decode"] = rel(card[2], host[2])
        errs["caches"] = max(rel(g, c) for g, c in zip(card[3:], host[3:]))
        check(max(errs.values()) <= LMX_TOL_BF16, f"lm_moe_ssd {arch} card "
              f"vs cpu bf16: {errs}")
        # the routing integers at float64 on the CPU run's router inputs
        c64 = dataclasses.replace(cfg, compute_dtype="float64")
        slots = 0
        for xt, w, _ in rc.calls:
            xt = xt.cpu().double()
            a = moe.route(c64, {"router": w.to(dev)}, xt.to(dev))
            b = moe.route(c64, {"router": w}, xt)
            check(all(torch.equal(x.cpu(), y) for x, y in zip(a[:3], b[:3])),
                  f"lm_moe_ssd {arch}: float64 routing differs card vs cpu")
            slots += a.expert_idx.numel()
        print(f"lm_moe_ssd {arch} card vs CPU (reduced: n_layers "
              f"{full.n_layers} -> 1; bf16 parameters and compute; B 1 x S "
              f"{S}): max|d|/max|cpu| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tokens routed alike in the forward, prefill, decode: "
              + ", ".join(f"{int(x.sum())} of {x.numel()}" for x in alike)
              + f"); float64 routing on the recorded router inputs: "
              f"{slots:,} (token, k) slots equal", flush=True)
        del tree
        return

    cfg = dataclasses.replace(full, n_layers=LMX_CUT,
                              compute_dtype="float32")
    tree = _per_layer_init(torch, cfg, _lm_model(torch, cfg, SEED + 5, dev))
    tree_cpu = T.map(lambda t: t.cpu(), tree)
    res = {}
    for dtype in ("float64", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        res[dtype] = (_lmx_outputs(torch, c, tree, toks, dev, S),
                      _lmx_outputs(torch, c, tree_cpu, toks, "cpu", S))
    (g64, rg), (c64, rc) = res["float64"]
    (g32, _), (c32, _) = res["float32"]
    names = ["forward", "prefill", "decode"] + [
        f"cache {i}" for i in range(len(g64) - 3)]
    e64 = [rel(g, c) for g, c in zip(g64, c64)]
    check(max(e64) <= LM_TOL, f"lm_moe_ssd {arch} card vs cpu float64: "
          f"{max(e64):.3e}")
    check(len(rg.calls) == len(rc.calls), "router calls differ")
    for (_, _, a), (_, _, b) in zip(rg.calls, rc.calls):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"lm_moe_ssd {arch}: routing differs card vs cpu (float64)")
    card = [rel(g, t) for g, t in zip(g32, c64)]
    host = [rel(c, t) for c, t in zip(c32, c64)]
    for n, a, b in zip(names, card, host):
        check(a <= max(LM_TOL, 4 * b), f"lm_moe_ssd {arch} card vs cpu "
              f"float32 {n}: {a:.3e} > max(LM_TOL, 4 x cpu {b:.3e})")
    extra = ""
    if cfg.ssm is not None:
        # prefill(S) -> decode(S) against forward(S + chunk)[S], on the card
        errs = []
        for dtype in ("float64", "float32"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            m = transformer.Transformer(c, tree, device=dev)
            want = m({"tokens": toks.to(dev)})[0][:, S]
            _, cache = m.prefill({"tokens": toks[:, :S].to(dev)}, S + 8)
            got, _ = m.decode_step({"token": toks[:, S:S + 1].to(dev),
                                    "pos": S}, cache)
            errs.append(rel(got.double(), want.double()))
            del m, cache
        check(max(errs) <= LM_TOL, f"lm_moe_ssd {arch} prefill -> decode vs "
              f"forward: {errs}")
        extra = (f"; on the card prefill({S}) -> decode vs forward("
                 f"{S + cfg.ssm.chunk})[{S}] float64 {errs[0]:.3e}, float32 "
                 f"{errs[1]:.3e}")
    slots = sum(k.numel() for _, _, (_, _, k) in rg.calls)
    print(f"lm_moe_ssd {arch} card vs CPU (reduced: n_layers "
          f"{full.n_layers} -> {LMX_CUT}, each layer's fan-in; B 1 x S {S})"
          f": float64 max|d|/max|cpu| {max(e64):.3e}"
          + (f", routing equal at {slots:,} (token, k) slots"
             if cfg.moe else "")
          + "; float32 against float64, card / CPU: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, a, b in
                      zip(names[:3], card[:3], host[:3]))
          + f", caches {max(card[3:]):.3e} / {max(host[3:]):.3e}" + extra,
          flush=True)


def phase_lm_moe_ssd(torch, np):
    """The MoE FFN and the Mamba-2 SSD block served on the card (plain
    PyTorch ops, no CUDA kernel of their own):

    1. ``launch.serve --full`` as a user runs it, olmoe-1b-7b and
       mamba2-780m (64-token prompts, 8 new tokens);
    2. bf16 serving through ``Engine.generate``, B = 4 x 1024-token
       prompts: olmoe-1b-7b and mamba2-780m at full width, depth cut to
       LMX_SERVE's (64 new tokens), arctic-480b at full width, one layer,
       bf16 parameters
       (16 new tokens); prefill ms, decode ms a step, tokens/s, peak
       memory, 8 profiled decode steps, and the MoE slots dropped by
       capacity and one layer split into its parts (``_lm_serve``);
    3. the card against the CPU (``_lmx_card_vs_cpu``)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import params as P
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    smi = _smi()
    for arch in ("olmoe-1b-7b", "mamba2-780m"):
        t = time.perf_counter()
        out = launch_serve.main(["--arch", arch, "--full", "--prompt-len",
                                 "64", "--max-new", "8", "--seed",
                                 str(SEED)])
        check(out.shape == (4, 8), f"launch.serve {arch}: {out.shape}")
        print(f"lm_moe_ssd launch.serve {arch} --full: {out.shape} in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        torch.cuda.empty_cache()
    for arch, layers, pdtype, new in LMX_SERVE:
        full = configs.get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        tree = P.materialize(transformer.model_specs(cfg), gen,
                             getattr(torch, pdtype), device=dev)
        torch.cuda.synchronize()
        print(f"lm_moe_ssd {arch}: {cfg.n_layers} of {full.n_layers} "
              f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{P.count_params(transformer.model_specs(cfg)):,} parameters"
              f" drawn on the card in {time.perf_counter() - t:.2f} s "
              f"({torch.cuda.memory_allocated() - base:,} bytes, {pdtype})",
              flush=True)
        _lm_serve(torch, np, "lm_moe_ssd", cfg, tree, new, smi)
        del tree
    for arch in ("olmoe_1b_7b", "mamba2_780m", "arctic_480b"):
        t = time.perf_counter()
        _lmx_card_vs_cpu(torch, np, arch)
        torch.cuda.empty_cache()
        print(f"lm_moe_ssd card vs CPU {arch}: "
              f"{time.perf_counter() - t:.2f} s", flush=True)


def _lmx_train(torch, np, arch, layers, smi, label="lm_moe_ssd_train"
               ) -> None:
    """One arch trained at bf16 on the card: the config's remat, AdamW
    (float32 moments), B = 4 x S = 1024 from ``data.synthetic`` (a vlm's
    with ``cross_embeds``), LMX_TRAIN_STEPS donated steps (step ms: median
    of steps 3-8, CUDA events), tokens/s, peak memory, a torch.profiler
    window; the losses and gradient norms finite. The CROSS gates and
    RG-LRU constants start off their inits (``_draw_consts``)."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as TS

    dev = torch.device("cuda")
    full = configs.get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    check(cfg.compute_dtype == "bfloat16", f"{arch} trains in bf16")
    tc = TS.TrainConfig()
    torch.cuda.empty_cache()
    state = TS.init_state(tc, _draw_consts(
        torch, _lm_model(torch, cfg, SEED, dev), SEED + 1))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      T.leaves(state.params) + T.leaves(state.opt.mu)
                      + T.leaves(state.opt.nu))
    shape = ShapeConfig("lmx_train", LM_TRAIN_S, LM_TRAIN_B, "train")
    data = synthetic.token_batches(cfg, shape, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, norms = [], [], []
    for i in range(LMX_TRAIN_STEPS):
        batch = next(data)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = TS.train_step(cfg, tc, state, batch, donate=True)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{label} {arch}: non-finite losses {losses} or grad "
          f"norms {norms}")
    check(int(state.opt.step) == LMX_TRAIN_STEPS, f"{arch}: step counter")
    timed = sorted(step_ms[2:])
    med = (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    box = {"state": state}

    def one():
        box["state"], _ = TS.train_step(cfg, tc, box["state"], next(data),
                                        donate=True)

    pr = _profile(torch, one, LMX_TRAIN_PROFILE_STEPS, f"{arch} train")
    tokens = LM_TRAIN_B * LM_TRAIN_S
    cut = ("" if layers is None else
           f" (reduced: n_layers {full.n_layers} -> {layers})")
    print(f"{label} {arch}{cut} [{smi}] (bf16, remat {cfg.remat}, "
          f"AdamW float32 moments, B {LM_TRAIN_B} x S {LM_TRAIN_S}): step "
          f"{med:.3f} ms (median of steps 3-{LMX_TRAIN_STEPS}: "
          + ", ".join(f"{x:.3f}" for x in step_ms[2:])
          + f"; step 1 {step_ms[0]:.3f}, step 2 {step_ms[1]:.3f}), "
          f"{tokens / med * 1e3:.1f} tokens/s; peak memory {peak:,} bytes "
          f"({state_bytes:,} of them the parameters and moments); losses "
          + ", ".join(f"{x:.6f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.6f}" for x in norms), flush=True)
    print(f"profile {label} {arch} ({LMX_TRAIN_PROFILE_STEPS} "
          f"steps): wall {pr['wall']:.3f} ms, device busy {pr['busy']:.3f}"
          f" ms, idle share {pr['idle']:.4f}, launches {pr['launches']:.1f}"
          f" a step (device ops {pr['ops']:.1f} a step); top: {pr['top']}",
          flush=True)
    del state, box
    torch.cuda.empty_cache()


def _lmx_train_card_vs_cpu(torch, np, arch, layers) -> None:
    """One AdamW ``train_step`` (two MoE dispatch groups) at full width cut
    to ``layers`` layers, B = 1, S = LMX_CPU_S, on the card and on the CPU
    from the same state (each layer's fan-in): the loss, gradient norm,
    parameters and moments within LM_TOL at float64, and the card's
    float32 step against the CPU's float64 one within LM_TOL, or else
    within 4 x the CPU's own float32 error."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.train import train_step as TS

    dev = torch.device("cuda")
    full = configs.get_config(arch)
    c2 = dataclasses.replace(full, n_layers=layers, compute_dtype="float32")
    tree = _per_layer_init(torch, c2, _lm_model(torch, c2, SEED + 6, dev))
    tree_cpu = T.map(lambda t: t.cpu(), tree)
    tok = np.random.default_rng(SEED + 7).integers(
        0, c2.vocab_size, (1, LMX_CPU_S)).astype(np.int32)
    tc = TS.TrainConfig(moe_num_groups=2)

    def step(dtype, params):
        c = dataclasses.replace(c2, compute_dtype=dtype)
        st, m = TS.train_step(c, tc, TS.init_state(tc, params),
                              {"tokens": tok})
        return {"loss": {"x": m["loss"]}, "aux": {"x": m["aux"]},
                "grad_norm": {"x": m["grad_norm"]}, "params": st.params,
                "mu": st.opt.mu, "nu": st.opt.nu}

    out64 = (step("float64", tree), step("float64", tree_cpu))
    e64 = {k: _rel_tree(torch, out64[0][k], out64[1][k]) for k in out64[0]
           if k != "aux" or c2.moe is not None}
    check(max(e64.values()) <= LM_TOL, f"lm_moe_ssd_train {arch} card vs "
          f"cpu, float64: {e64}")
    truth = out64[1]
    card32 = step("float32", tree)
    card = {k: _rel_tree(torch, card32[k], truth[k]) for k in e64}
    # the CPU's float32 step (a minute for olmoe's 1.04 B parameters) is
    # needed only where the card's float32 error exceeds LM_TOL
    host = ({k: _rel_tree(torch, v, truth[k]) for k, v in
             step("float32", tree_cpu).items() if k in e64}
            if max(card.values()) > LM_TOL else None)
    for k in e64 if host is not None else ():
        check(card[k] <= max(LM_TOL, 4 * host[k]),
              f"lm_moe_ssd_train {arch} card vs cpu float32 {k}: card "
              f"{card[k]:.3e} > max(LM_TOL, 4 x cpu {host[k]:.3e})")
    print(f"lm_moe_ssd_train {arch} train step card vs CPU (reduced: "
          f"n_layers {full.n_layers} -> {layers}, B 1 x S {LMX_CPU_S}, each"
          f" layer's fan-in; AdamW, moe_num_groups 2): float64 "
          "max|d|/max|cpu| " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in e64.items())
          + "; float32 against float64, card / CPU: "
          + ", ".join(f"{k} {card[k]:.3e} / "
                      + ("-" if host is None else f"{host[k]:.3e}")
                      for k in e64)
          + (" (the card within LM_TOL: the CPU's float32 step not run)"
             if host is None else ""), flush=True)
    del out64, card32, tree, tree_cpu
    torch.cuda.empty_cache()


def phase_lm_moe_ssd_train(torch, np):
    """The MoE FFN and the SSD block trained on the card (plain PyTorch
    ops): ``launch.train --full`` for mamba2-780m (full depth) and
    olmoe-1b-7b (``--layers 4``), two steps each; ``_lmx_train`` for each
    of LMX_TRAIN; one train step against the CPU for olmoe and mamba2
    (``_lmx_train_card_vs_cpu``). arctic-480b does not train here: one
    layer's float32 parameters and moments are 168.8 GB (it waits for the
    multi-GPU mesh, ROADMAP queue 1)."""
    import tempfile

    from repro_torch.launch import train as launch_train

    smi = _smi()
    for arch, layers in (("mamba2-780m", None), ("olmoe-1b-7b", 4)):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="lmx_ckpt_") as ck:
            args = ["--arch", arch, "--full", "--steps", "2", "--batch",
                    str(LM_TRAIN_B), "--seq", str(LM_TRAIN_S), "--ckpt-dir",
                    ck, "--ckpt-every", "100", "--seed", str(SEED)]
            if layers:
                args += ["--layers", str(layers)]
            state, rep = launch_train.main(args)
            check(rep.steps_run == 2 and all(np.isfinite(rep.losses)),
                  f"launch.train {arch}: {rep}")
            del state
        torch.cuda.empty_cache()
        print(f"lm_moe_ssd_train launch.train {arch} --full"
              + (f" --layers {layers}" if layers else "")
              + f": 2 steps in {time.perf_counter() - t:.2f} s (losses "
              + ", ".join(f"{x:.6f}" for x in rep.losses) + ")", flush=True)
    for arch, layers in LMX_TRAIN:
        _lmx_train(torch, np, arch, layers, smi)
    for arch, layers in LMX_TRAIN_CPU:
        t = time.perf_counter()
        _lmx_train_card_vs_cpu(torch, np, arch, layers)
        print(f"lm_moe_ssd_train card vs CPU {arch}: "
              f"{time.perf_counter() - t:.2f} s", flush=True)




# lm_rglru_cross: the RG-LRU hybrid (recurrentgemma-9b) and the vlm
# (llama-3.2-vision-11b, its vision frontend a stub: 1601 image-token
# embeddings from ``stubs.synthetic_batch``) served at full width and
# depth on the card, bf16, B = 4 x 1024-token prompts, 64 new tokens, and
# trained at LMR_TRAIN_LAYERS layers: one super-block (recurrentgemma's
# RG-LRU, RG-LRU, LOCAL and its 2 remainder RG-LRU layers; the vlm's 4
# GLOBAL and 1 CROSS). At full depth their float32 parameters and AdamW
# moments are 102.9 GB and 117.3 GB, which one card does not hold. No
# kernel of their own: plain PyTorch ops.
LMR_ARCHS = ("recurrentgemma_9b", "llama32_vision_11b")
# serving depth (PR 24, for the script's time): 38 -> 14 (4 super-blocks
# and the 2 remainder layers), 40 -> 10 (2 super-blocks)
LMR_SERVE_LAYERS = {"recurrentgemma_9b": 14, "llama32_vision_11b": 10}
LMR_TRAIN_LAYERS = 5
LMR_CPU_S = 256                 # the card-against-CPU prompt (B = 1)
LMR_TOL64 = 1e-10               # card against CPU at float64 compute
# the leaves initialised to constants that would hide a fault: a CROSS
# layer's gates (zeros: tanh(0) = 0 makes the layer an identity) and the
# RG-LRU's biases and Lambda; every check draws them off their inits
LMR_GATES = ("gate", "ffn_gate")
LMR_RGLRU_CONSTS = ("conv_b", "b_a", "b_x", "lambda_p")


def _draw_consts(torch, tree: dict, seed: int) -> dict:
    """``tree`` with its CROSS gates and RG-LRU constants moved off their
    inits by U(-1, 1), in place, each leaf from a generator on its device
    seeded by ``seed`` and its path (no such leaf in the other families'
    trees)."""
    def walk(node, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in LMR_GATES or ("rec" in path and k in LMR_RGLRU_CONSTS):
                key = "/".join(path + (k,))
                g = torch.Generator(device=v.device).manual_seed(
                    seed + sum(i * ord(c) for i, c in enumerate(key)))
                v.add_(2 * torch.rand(v.shape, generator=g, device=v.device,
                                      dtype=v.dtype) - 1)

    walk(tree, ())
    return tree


def _lmr_split(torch, cfg, compute, T_tokens: int, cross) -> dict:
    """One layer of each kind of an RG-LRU or vlm stack, at ``T_tokens``
    tokens (B = LM_B rows), on the first super-block's compute weights
    (CUDA events, median of 5): the whole layer (``_prefill_block`` at
    prefill, ``_decode_block`` against a zero cache at decode), so a CROSS
    layer stands beside a GLOBAL one; for RG-LRU also its parts: the
    recurrent block (``rglru_forward`` / ``rglru_decode_step``), of it the
    scan (``rglru.scan`` of [B, S, di] float32) and the gates
    (``rglru._gates``), and the MLP."""
    from repro_torch import tree as T
    from repro_torch.configs.base import RGLRU
    from repro_torch.models import layers, rglru, transformer

    dev = torch.device("cuda")
    cd = layers.compute_dtype(cfg)
    S = T_tokens // LM_B
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((LM_B, S, cfg.d_model), generator=g, device=dev,
                    dtype=torch.float32).to(cd)
    cross = None if cross is None else cross.to(cd)
    out: dict = {}
    with torch.inference_mode():
        for i, kind in enumerate(cfg.layer_pattern):
            if kind in out:
                continue
            p = T.map(lambda t: t[0], compute["blocks"][f"pos{i}"])
            if S > 1:
                out[kind] = _events_ms(torch, lambda: transformer
                                       ._prefill_block(cfg, kind, p, x,
                                                       cross))
                continue
            cache = {k: torch.zeros(sd.shape, dtype=sd.dtype, device=dev)
                     for k, sd in transformer._layer_cache_struct(
                         cfg, kind, LM_B, LM_PROMPT + LM_NEW).items()}
            out[kind] = _events_ms(torch, lambda: transformer._decode_block(
                cfg, kind, p, x, cache, LM_PROMPT))
        if RGLRU in cfg.layer_pattern:
            i = cfg.layer_pattern.index(RGLRU)
            p = T.map(lambda t: t[0], compute["blocks"][f"pos{i}"])
            di = rglru._dims(cfg)[0]
            xr = torch.randn((LM_B, S, di) if S > 1 else (LM_B, di),
                             generator=g, device=dev, dtype=torch.float32)
            if S > 1:
                out["recurrent block"] = _events_ms(
                    torch, lambda: rglru.rglru_forward(cfg, p["rec"], x))
                a, gx = rglru._gates(cfg, p["rec"], xr)
                out["scan"] = _events_ms(torch, lambda: rglru.scan(a, gx))
            else:
                st = rglru.init_state(cfg, LM_B, device=dev)
                st = st._replace(conv=st.conv.to(cd))
                out["recurrent block"] = _events_ms(
                    torch, lambda: rglru.rglru_decode_step(cfg, p["rec"], x,
                                                           st))
            out["gates"] = _events_ms(torch, lambda: rglru._gates(
                cfg, p["rec"], xr))
            out["mlp"] = _events_ms(torch, lambda: layers.mlp(cfg, p["ffn"],
                                                              x))
    return out


def _lmr_model(torch, cfg, seed: int, dev, per_layer: bool = False):
    """float32 parameters drawn on ``dev`` (each layer at its own fan-in
    if ``per_layer``), the CROSS gates and RG-LRU constants off their
    inits."""
    tree = _lm_model(torch, cfg, seed, dev)
    if per_layer:
        tree = _per_layer_init(torch, cfg, tree)
    return _draw_consts(torch, tree, seed + 1)


def _lmr_cross_embeds(torch, cfg, B: int, seed: int) -> dict:
    """{"cross_embeds": [B, n_cross_tokens, D] on the card} from
    ``stubs.synthetic_batch`` (the stub vision frontend), or {} for a
    model without CROSS layers."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import stubs

    if cfg.family != "vlm":
        return {}
    b = stubs.synthetic_batch(cfg, ShapeConfig("lmr", 8, B, "prefill"),
                              seed=seed, device="cuda")
    return {"cross_embeds": b["cross_embeds"]}


def _lmr_card_vs_cpu(torch, np, arch) -> None:
    """One arch at full width, depth cut to one super-block, B = 1, S =
    LMR_CPU_S (+ the 1601 image tokens for the vlm), each layer at its own
    fan-in, the gates off their inits: forward, prefill (logits and every
    cache leaf) and one decode step on the card and on the CPU from the
    same parameters. At float64 the two agree within LMR_TOL64; at
    float32 the card's results against the CPU's float64 ones are within
    LM_TOL, or else within 4 x the CPU's own float32 error (the CPU's
    float32 run is made only then). On the card, prefill(S) -> decode(S)
    equals forward(S + 1)[S] within LM_TOL at both dtypes."""
    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=len(full.layer_pattern),
                              compute_dtype="float32")
    tree = _lmr_model(torch, cfg, SEED + 8, dev, per_layer=True)
    tree_cpu = T.map(lambda t: t.cpu(), tree)
    S = LMR_CPU_S
    rng = np.random.default_rng(SEED + 10)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S + 1)))
    extra = {k: v.float().cpu() for k, v in _lmr_cross_embeds(
        torch, cfg, 1, SEED + 11).items()}

    def outputs(c, tr, where):
        m = transformer.Transformer(c, tr, device=where)
        ex = {k: v.to(where) for k, v in extra.items()}
        fwd = m({"tokens": toks[:, :S].to(where), **ex})[0]
        pre, cache = m.prefill({"tokens": toks[:, :S].to(where), **ex},
                               S + 8)
        dec, _ = m.decode_step({"token": toks[:, S:].to(where), "pos": S},
                               cache)
        out = [x.double().cpu() for x in (fwd, pre, dec, *T.leaves(cache))]
        del m, cache
        return out

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    c64 = dataclasses.replace(cfg, compute_dtype="float64")
    t = time.perf_counter()
    g64 = outputs(c64, tree, dev)
    torch.cuda.empty_cache()
    h64 = outputs(c64, tree_cpu, "cpu")
    t64 = time.perf_counter() - t
    names = ["forward", "prefill", "decode"] + [
        f"cache {i}" for i in range(len(g64) - 3)]
    e64 = [rel(g, c) for g, c in zip(g64, h64)]
    check(max(e64) <= LMR_TOL64, f"lm_rglru_cross {arch} card vs cpu "
          f"float64: {max(e64):.3e} > {LMR_TOL64}")
    g32 = outputs(cfg, tree, dev)
    card = [rel(g, c) for g, c in zip(g32, h64)]
    host = None
    if max(card) > LM_TOL:
        host = [rel(c, t) for c, t in zip(outputs(cfg, tree_cpu, "cpu"),
                                          h64)]
        for n, a, b in zip(names, card, host):
            check(a <= max(LM_TOL, 4 * b), f"lm_rglru_cross {arch} card vs "
                  f"cpu float32 {n}: {a:.3e} > max(LM_TOL, 4 x cpu {b:.3e})")
    # prefill(S) -> decode(S) against forward(S + 1)[S], on the card
    errs = []
    for c in (c64, cfg):
        m = transformer.Transformer(c, tree, device=dev)
        ex = {k: v.to(dev) for k, v in extra.items()}
        want = m({"tokens": toks.to(dev), **ex})[0][:, S]
        _, cache = m.prefill({"tokens": toks[:, :S].to(dev), **ex}, S + 8)
        got, _ = m.decode_step({"token": toks[:, S:].to(dev), "pos": S},
                               cache)
        errs.append(rel(got.double(), want.double()))
        del m, cache
    check(max(errs) <= LM_TOL, f"lm_rglru_cross {arch} prefill -> decode "
          f"vs forward: {errs}")
    print(f"lm_rglru_cross {arch} card vs CPU (reduced: n_layers "
          f"{full.n_layers} -> {cfg.n_layers}, one super-block, each "
          f"layer's fan-in, gates drawn; B 1 x S {S}"
          + (f" + {cfg.n_cross_tokens} image tokens" if extra else "")
          + f"): float64 max|d|/max|cpu| {max(e64):.3e} (forward "
          f"{e64[0]:.3e}, prefill {e64[1]:.3e}, decode {e64[2]:.3e}, "
          f"caches {max(e64[3:]):.3e}; both devices {t64:.2f} s); float32 "
          "against float64, card / CPU: "
          + ", ".join(f"{n} {a:.3e} / "
                      + ("-" if host is None else f"{host[i]:.3e}")
                      for i, (n, a) in enumerate(zip(names[:3], card[:3])))
          + f", caches {max(card[3:]):.3e}"
          + (" (the card within LM_TOL: the CPU's float32 run not made)"
             if host is None else "")
          + f"; on the card prefill({S}) -> decode vs forward({S + 1})[{S}]"
          f" float64 {errs[0]:.3e}, float32 {errs[1]:.3e}", flush=True)
    del tree, tree_cpu
    torch.cuda.empty_cache()


def phase_lm_rglru_cross(torch, np):
    """The RG-LRU hybrid and the vlm served on the card (plain PyTorch
    ops, no CUDA kernel of their own):

    1. ``launch.serve --full`` as a user runs it for recurrentgemma-9b
       (64-token prompts, 8 new tokens); for the vlm the launcher, and
       ``Engine.generate``, refuse (its prefill needs ``cross_embeds``);
    2. bf16 serving of B = 4 x 1024-token prompts and 64 new tokens at
       full width, depth cut to LMR_SERVE_LAYERS, float32 parameters
       drawn on the card with the
       gates off their inits: recurrentgemma-9b through
       ``Engine.generate``, llama-3.2-vision-11b through
       ``Transformer.prefill`` with ``cross_embeds`` and ``decode_step``
       (the engine's loop); prefill ms, decode ms a step, tokens/s, peak
       memory, 8 profiled decode steps, and one layer of each kind split
       into its parts (``_lm_serve``, ``_lmr_split``);
    3. the card against the CPU (``_lmr_card_vs_cpu``)."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, EngineConfig

    dev = torch.device("cuda")
    smi = _smi()
    t = time.perf_counter()
    out = launch_serve.main(["--arch", "recurrentgemma-9b", "--full",
                             "--prompt-len", "64", "--max-new", "8",
                             "--seed", str(SEED)])
    check(out.shape == (4, 8), f"launch.serve recurrentgemma-9b: {out.shape}")
    print(f"lm_rglru_cross launch.serve recurrentgemma-9b --full: "
          f"{out.shape} in {time.perf_counter() - t:.2f} s", flush=True)
    torch.cuda.empty_cache()
    try:
        launch_serve.main(["--arch", "llama-3.2-vision-11b", "--full"])
        fail("launch.serve served the vlm without cross_embeds")
    except SystemExit as e:
        print(f"lm_rglru_cross launch.serve llama-3.2-vision-11b refuses: "
              f"{e}", flush=True)
    for arch in LMR_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  n_layers=LMR_SERVE_LAYERS[arch])
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        tree = _lmr_model(torch, cfg, SEED, dev)
        torch.cuda.synchronize()
        print(f"lm_rglru_cross {arch}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{P.count_params(transformer.model_specs(cfg)):,} parameters"
              f" drawn on the card in {time.perf_counter() - t:.2f} s "
              f"({torch.cuda.memory_allocated() - base:,} bytes, float32)",
              flush=True)
        extra = _lmr_cross_embeds(torch, cfg, LM_B, SEED)
        if extra:
            small = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))
            eng = Engine(small, _lmr_model(torch, small, SEED, dev),
                         EngineConfig(max_seq=16, batch_slots=1), device=dev)
            try:
                eng.generate(np.zeros((1, 4), np.int32), 2)
                fail("Engine.generate served the vlm without cross_embeds")
            except ValueError as e:
                check("cross_embeds" in str(e), f"engine refusal: {e}")
                print(f"lm_rglru_cross Engine.generate refuses the vlm: {e}",
                      flush=True)
            del eng
            torch.cuda.empty_cache()
        _lm_serve(torch, np, "lm_rglru_cross", cfg, tree, LM_NEW, smi, extra)
        del tree, extra
    for arch in LMR_ARCHS:
        t = time.perf_counter()
        _lmr_card_vs_cpu(torch, np, arch)
        torch.cuda.empty_cache()
        print(f"lm_rglru_cross card vs CPU {arch}: "
              f"{time.perf_counter() - t:.2f} s", flush=True)


def phase_lm_rglru_cross_train(torch, np):
    """The RG-LRU hybrid and the vlm trained on the card (plain PyTorch
    ops) at LMR_TRAIN_LAYERS layers (one super-block; recurrentgemma's
    2 remainder RG-LRU layers too): ``launch.train --full --layers 5``,
    two steps each (the vlm's ``data.synthetic`` batches carry
    ``cross_embeds``); then ``_lmx_train`` for each: 8 donated AdamW steps
    at bf16, step ms, tokens/s, launches, idle share, peak memory, finite
    losses and gradient norms."""
    import tempfile

    from repro_torch.launch import train as launch_train

    smi = _smi()
    for arch in ("recurrentgemma-9b", "llama-3.2-vision-11b"):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="lmr_ckpt_") as ck:
            state, rep = launch_train.main([
                "--arch", arch, "--full", "--layers", str(LMR_TRAIN_LAYERS),
                "--steps", "2", "--batch", str(LM_TRAIN_B), "--seq",
                str(LM_TRAIN_S), "--ckpt-dir", ck, "--ckpt-every", "100",
                "--seed", str(SEED)])
            check(rep.steps_run == 2 and all(np.isfinite(rep.losses)),
                  f"launch.train {arch}: {rep}")
            del state
        torch.cuda.empty_cache()
        print(f"lm_rglru_cross_train launch.train {arch} --full --layers "
              f"{LMR_TRAIN_LAYERS}: 2 steps in {time.perf_counter() - t:.2f}"
              " s (losses " + ", ".join(f"{x:.6f}" for x in rep.losses)
              + ")", flush=True)
    for arch in LMR_ARCHS:
        _lmx_train(torch, np, arch, LMR_TRAIN_LAYERS, smi,
                   label="lm_rglru_cross_train")


LMA_B, LMA_S = 2, 4096          # one layer's attention at full width
LMA_FLASH_ARCH = "granite_8b"   # 32 query heads over 8 kv heads of 128
LMA_CROSS_ARCH = "llama32_vision_11b"   # the same heads, N = 1601 keys
LMA_WINDOW = 1000               # a window whose rows' first chunks go dead
# the increment predicted for each path over one forward and backward
# of the bf16 CROSS attention, GB (PERF.md §6)
LMA_CROSS_DENSE_GB, LMA_CROSS_BLOCKED_GB = 5.0, 1.0
LMA_TOL = {"float32": LM_TOL, "bfloat16": 3e-2}


def _lma_oracle():
    """The frozen out-of-place streaming attention, ``_OracleFlash``, that
    ``tests/test_torch_lm_attention_memory.py`` holds ``layers._Flash``
    to (that file imports no JAX)."""
    import importlib.util

    path = ROOT / "tests" / "test_torch_lm_attention_memory.py"
    spec = importlib.util.spec_from_file_location("lma_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._OracleFlash


def _lma_pass(torch, fn, xs, do):
    """One forward and backward of ``fn`` on leaf copies of ``xs``: (out,
    dq, dk, dv), the increment of ``max_memory_allocated`` over what was
    allocated before it (its outputs included) in GB, and the median ms
    of 5 more (CUDA events)."""
    leaves = [x.detach().clone().requires_grad_() for x in xs]

    def once():
        out = fn(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, do))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = once()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return got, peak, _events_ms(torch, once)


def _lma_inputs(torch, cfg, T: int, dtype, seed: int):
    """q [B, S, Hq, D], k and v [B, T, Hkv, D] and a cotangent like q,
    standard normal from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return (draw(LMA_B, LMA_S, hq, dh), draw(LMA_B, T, hkv, dh),
            draw(LMA_B, T, hkv, dh), draw(LMA_B, LMA_S, hq, dh))


def phase_lm_attention_memory(torch, np):
    """The train step's attention in block-sized memory, one layer's
    attention at full width, B = 2, S = 4096 (plain PyTorch ops):

    * the vlm's CROSS attention over its N = 1601 image tokens (32 heads
      over 8 kv heads of 128, attn_chunk 512), bf16 and float32: the query
      blocks (``layers._CrossBlocks``) against the dense path
      (``_gqa_scores_out`` under autograd) on the same inputs, the output
      and dq, dk, dv within LMA_TOL of max |dense| (the largest
      differences printed), and each path's memory increment over one
      forward and backward and its ms;
    * granite-8b's streaming attention (``layers._Flash``, the same heads,
      chunk 512), bf16 (no window, and window LMA_WINDOW) and float32:
      the output and dq, dk, dv equal bit for bit to the frozen
      out-of-place code's, and both codes' increments and ms beside the
      block sizes (the new code: at most two float32 blocks of [B, Hkv,
      G, S, chunk] and one bf16 block live)."""
    from repro_torch import configs
    from repro_torch.models import layers

    smi = _smi()
    cross_cfg = configs.get_config(LMA_CROSS_ARCH)
    N = cross_cfg.n_cross_tokens
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(cross_cfg, compute_dtype=dtype)
        td = layers._DTYPES[dtype]
        q, k, v, do = _lma_inputs(torch, cfg, N, td, SEED)
        mask = torch.zeros((1, 1, LMA_S, N), device="cuda")
        blocked, b_gb, b_ms = _lma_pass(
            torch, lambda *a: layers._CrossBlocks.apply(*a, cfg),
            (q, k, v), do)
        dense, d_gb, d_ms = _lma_pass(
            torch, lambda *a: layers._gqa_scores_out(cfg, *a, mask),
            (q, k, v), do)
        errs = []
        for name, got, want in zip(("out", "dq", "dk", "dv"), blocked,
                                   dense):
            check(got.dtype == td and bool(torch.isfinite(got).all()),
                  f"lm_attention_memory CROSS {dtype} {name}: not finite")
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            check(err <= LMA_TOL[dtype], f"lm_attention_memory CROSS "
                  f"{dtype} {name}: {err:.3e} > {LMA_TOL[dtype]}")
            errs.append(f"{name} {err:.3e}")
        check(b_gb < d_gb / 4, f"lm_attention_memory CROSS {dtype}: the "
              f"blocks took {b_gb:.3f} GB, the dense path {d_gb:.3f}")
        print(f"lm_attention_memory CROSS {dtype} B = {LMA_B}, S = {LMA_S}, "
              f"N = {N}, blocks of {cfg.attn_chunk}: blocked vs dense max|d| "
              f"/ max|dense| {', '.join(errs)}; increment over forward + "
              f"backward: blocked {b_gb:.4f} GB, dense {d_gb:.4f} GB "
              f"(predicted at bf16: under {LMA_CROSS_BLOCKED_GB} / about "
              f"{LMA_CROSS_DENSE_GB}); ms: blocked {b_ms:.3f}, dense "
              f"{d_ms:.3f} ({smi})", flush=True)
        del q, k, v, do, mask, blocked, dense

    oracle = _lma_oracle()
    flash_cfg = configs.get_config(LMA_FLASH_ARCH)
    chunk = flash_cfg.attn_chunk
    for dtype, window in (("bfloat16", None), ("bfloat16", LMA_WINDOW),
                          ("float32", None)):
        td = layers._DTYPES[dtype]
        q, k, v, do = _lma_inputs(torch, flash_cfg, LMA_S, td, SEED + 1)
        new, n_gb, n_ms = _lma_pass(
            torch, lambda *a: layers._Flash.apply(*a, window, chunk),
            (q, k, v), do)
        old, o_gb, o_ms = _lma_pass(
            torch, lambda *a: oracle.apply(*a, window, chunk), (q, k, v), do)
        for name, got, want in zip(("out", "dq", "dk", "dv"), new, old):
            check(bool(torch.isfinite(got).all()),
                  f"lm_attention_memory flash {dtype} {name}: not finite")
            check(torch.equal(got, want), f"lm_attention_memory flash "
                  f"{dtype} window {window} {name}: not bitwise the "
                  f"out-of-place code's (max|d| "
                  f"{(got.float() - want.float()).abs().max().item():.3e})")
        check(n_gb < o_gb, f"lm_attention_memory flash {dtype}: in place "
              f"{n_gb:.3f} GB, out of place {o_gb:.3f}")
        blk = LMA_B * flash_cfg.n_heads * LMA_S * chunk
        print(f"lm_attention_memory flash {dtype} window {window} B = "
              f"{LMA_B}, S = {LMA_S}, chunk {chunk}: out, dq, dk, dv bitwise "
              f"the out-of-place code's; increment over forward + backward: "
              f"in place {n_gb:.4f} GB, out of place {o_gb:.4f} GB (a "
              f"float32 block {blk * 4 / 1e9:.4f} GB, a {dtype} block "
              f"{blk * td.itemsize / 1e9:.4f} GB); ms: in place {n_ms:.3f}, "
              f"out of place {o_ms:.3f} ({smi})", flush=True)
        del q, k, v, do, new, old
    torch.cuda.empty_cache()


LMM_ARCH = "gemma3_1b"
LMM_LAYERS = 6                  # one super-block of gemma3-1b's 26 layers
LMM_B, LMM_S = 4, 1024
LMM_MESH = (2, 2)               # (data, model)
LMM_RESHARD = (4, 1)
LMM_TIMED = 1                   # bf16 steps timed a side, after one
LMM_MOE = "olmoe_1b_7b"         # one layer, the loss only
LMM_LOSS_TOL = 1e-5
LMM_TOL = 1e-4
# the vocabulary-parallel loss: the loss and the embedding's gradient
# (gemma3 ties the head to it) against the unsharded port's, relative
# (PERF.md §2; the bf16 loss at the bf16 tolerance)
LMM_GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# A bf16 gradient at this init is itself far from the float32 one (the
# unsharded one by 1.706e-01 of its largest element on the card, PERF.md
# §6), so two bf16 runs that sum in another order differ by as
# much: the sharded bf16 gradient is held to the float32 one instead, no
# further from it than this many times the unsharded bf16 gradient is.
LMM_BF16_GRAD_FACTOR = 1.5
# a rank's bf16 peak with the vocabulary whole in the loss (PERF.md §6)
LMM_WHOLE_VOCAB_PEAK_GIB = 12.1
LMM_TIMEOUT_S = 120.0            # the phase's limit


def _lmm_cfg(arch: str, layers: int, dtype: str):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), n_layers=layers,
                               compute_dtype=dtype)


def _lmm_params(torch, cfg, dev) -> dict:
    return _per_layer_init(torch, cfg, _lm_model(torch, cfg, SEED, dev))


def _lmm_batches(cfg, n: int) -> list:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic

    data = synthetic.token_batches(
        cfg, ShapeConfig("lm_mesh", LMM_S, LMM_B, "train"), seed=SEED)
    return [next(data) for _ in range(n)]


def _lmm_host(torch, state) -> list:
    """The leaves of a plain state on the card, as host copies."""
    from repro_torch import tree as T

    return [x.detach().to("cpu", copy=True) for x in T.leaves(state)]


def _lmm_keep(torch, state) -> list:
    """The leaves of a plain state on the card, as copies on the card
    (rank 0 keeps the unsharded run's states there until it has compared
    the sharded ones: a host copy of 5.6 GB costs seconds each way)."""
    from repro_torch import tree as T

    return [x.detach().clone() for x in T.leaves(state)]


def _lmm_rel_host(torch, got, ref) -> float:
    """max |got - ref| / max |ref| of one leaf (0 for an integer leaf),
    on ``ref``'s device."""
    if not ref.dtype.is_floating_point:
        return 0.0
    ref = ref.double()
    scale = ref.abs().max().item() or 1.0
    return (got.to(ref.device).double() - ref).abs().max().item() / scale


def _lmm_rel(torch, sharded_state, ref_leaves, rank: int) -> float:
    """max over leaves of max |sharded - ref| / max |ref|: every rank
    gathers each leaf whole in turn (collective), rank 0 compares it on
    the card with the unsharded run's host copy."""
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as shd

    worst = 0.0
    for x, r in zip(T.leaves(sharded_state), ref_leaves or
                    [None] * len(T.leaves(sharded_state))):
        whole = shd.gather(x)
        if rank == 0:
            worst = max(worst, _lmm_rel_host(torch, whole,
                                             r.to(whole.device)))
        del whole
    return worst


def _lmm_steps(torch, cfg, tc, state, batches):
    """``len(batches)`` steps (donating); returns (state, losses, ms a
    step on the host's clock around a synchronised step)."""
    from repro_torch.train import train_step as TS

    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = TS.train_step(cfg, tc, state, b, donate=True)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(loss)
    return state, losses, ms


@contextlib.contextmanager
def _lmm_vocab_blocks(seen: list):
    """Appends the local vocabulary width of every block the loss's
    cross-entropy (``transformer._VocabCE``) computes on inside."""
    from repro_torch.models import transformer

    block = transformer._VocabCE.apply

    def apply(x, *rest):
        seen.append(int(x.shape[-1]))
        return block(x, *rest)

    transformer._VocabCE.apply = staticmethod(apply)
    try:
        yield
    finally:
        del transformer._VocabCE.apply   # back to Function.apply


@contextlib.contextmanager
def _lmm_first_grad(store: dict, key: str, rank: int):
    """``store[key]`` = (loss, the embedding's gradient whole as a host
    copy on rank 0, None elsewhere) of the first ``train_step`` inside,
    taken where it computes them (``train_step.grad_fn``): a step at the
    initial parameters gives them without a pass of its own. The gather
    is collective, at the same point on every rank."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import train_step as TS

    orig = TS.grad_fn

    def grad_fn(cfg, tc, params, batch):
        loss, parts, grads = orig(cfg, tc, params, batch)
        if key not in store:
            g = shd.gather(grads["embed"]).detach()
            store[key] = (float(shd.gather(loss)),
                          g.to("cpu", copy=True) if rank == 0 else None)
            del g
        return loss, parts, grads

    TS.grad_fn = grad_fn
    try:
        yield
    finally:
        TS.grad_fn = orig


def _lmm_grad_diag(torch, got, ref, f32, dev) -> dict:
    """The sharded gradient ``got`` against the unsharded ``ref`` (host
    copies), on the card: max |got - ref| / max |ref| ("max_rel"), the
    norm-wise ||got - ref|| / ||ref||, and each against the unsharded
    float32 gradient ``f32`` the same two ways; where the largest
    difference sits (row, column, both values, max |ref|)."""
    g, r, a = (x.to(dev).double() for x in (got, ref, f32))
    scale = r.abs().max()
    diff = (g - r).abs()
    i = int(diff.argmax())
    row, col = divmod(i, r.shape[-1])
    out = {"max_rel": float(diff.max() / scale),
           "norm_rel": float(diff.norm() / r.norm()),
           "at": [row, col, float(g.view(-1)[i]), float(r.view(-1)[i]),
                  float(scale)]}
    for name, x in (("got", g), ("ref", r)):
        out[f"{name}_vs_f32_max_rel"] = float((x - a).abs().max()
                                              / a.abs().max())
        out[f"{name}_vs_f32_norm_rel"] = float((x - a).norm() / a.norm())
    return out


def _lm_mesh_rank(rank, world, ckpt_dir):
    """One rank of phase ``lm_mesh`` (``repro_torch.launch.ranks.spawn``
    starts 4; the docstring of :func:`phase_lm_mesh` says what it does).
    Returns what this rank measured; rank 0 also what it checked."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import transformer
    from repro_torch.train import loop as loop_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    f32 = _lmm_cfg(LMM_ARCH, LMM_LAYERS, "float32")
    bf16 = _lmm_cfg(LMM_ARCH, LMM_LAYERS, "bfloat16")
    moe = _lmm_cfg(LMM_MOE, 1, "float32")
    tc = TS.TrainConfig(opt=opt_mod.OptConfig())
    batches = _lmm_batches(f32, 3)
    moe_batch = _lmm_batches(moe, 1)[0]
    out = {"rank": rank, "device": str(dev),
           "backend": dist.get_backend()}
    t0 = time.perf_counter()
    start = t0

    def note(what):
        # rank 0's progress, so that a phase cut by its time limit shows
        # how far it got
        if rank == 0:
            print(f"lm_mesh rank 0 at {time.perf_counter() - start:.1f} s: "
                  f"{what}", file=sys.stderr, flush=True)

    # 1. rank 0: the unsharded port on the same card (the others wait)
    ref = {}
    if rank == 0:
        state = TS.init_state(tc, _lmm_params(torch, f32, dev))
        ref["grad"] = {}
        with _lmm_first_grad(ref["grad"], "float32", rank):
            state, ref["losses"], _ = _lmm_steps(torch, f32, tc, state,
                                                 batches[:2])
        note("unsharded float32 steps 1-2")
        a = torch.cuda.memory_allocated()
        ref["step2"] = _lmm_keep(torch, state)
        kept = torch.cuda.memory_allocated() - a
        state, loss3, _ = _lmm_steps(torch, f32, tc, state, batches[2:])
        ref["losses"] += loss3
        a = torch.cuda.memory_allocated()
        ref["step3"] = _lmm_keep(torch, state)
        kept += torch.cuda.memory_allocated() - a   # the kept states' bytes
        note("unsharded float32 step 3")
        del state
        torch.cuda.empty_cache()
        state = TS.init_state(tc, _lmm_params(torch, bf16, dev))
        torch.cuda.reset_peak_memory_stats()
        with _lmm_first_grad(ref["grad"], "bfloat16", rank):
            state, _, ms = _lmm_steps(torch, bf16, tc, state,
                                      batches[:1 + LMM_TIMED])
        out["plain_bf16_ms"] = ms[1:]
        out["plain_peak"] = torch.cuda.max_memory_allocated() - kept
        note(f"unsharded bf16 steps {ms}")
        del state
        torch.cuda.empty_cache()
        prm = _lmm_params(torch, moe, dev)
        with torch.no_grad():
            loss, _ = transformer.loss_fn(
                moe, prm, TS.batch_on(moe_batch, dev),
                num_groups=LMM_MESH[0])
        ref["moe_loss"] = float(loss)
        del prm, loss
        torch.cuda.empty_cache()
    out["ref_s"] = time.perf_counter() - t0
    collectives.barrier()
    note("reference done")

    # 2. float32 on (2, 2): two steps against the unsharded port, then a
    # checkpoint written collectively
    t0 = time.perf_counter()
    mesh = RankMesh(LMM_MESH, ("data", "model"), device=dev.type)
    sh = TS.state_shardings(f32, tc, mesh)
    state = shd.distribute(TS.init_state(tc, _lmm_params(torch, f32, dev)),
                           sh)
    torch.cuda.empty_cache()
    note("distributed")
    out["local_elems"] = shd.local_numel(state.params)
    out["whole_elems"] = sum(int(np.prod(x.shape))
                             for x in T.leaves(state.params))
    # the vocabulary-parallel loss at the initial parameters (the first
    # step's): its local blocks, its value and the embedding's gradient
    out["vocab_blocks"] = []
    out["grad"], out["grad_rel"], out["grad_diag"] = {}, {}, {}

    def grad_rel(dtype):
        loss, g = out["grad"].pop(dtype)
        if rank == 0:
            rloss, rg = ref["grad"][dtype]
            d = _lmm_grad_diag(torch, g, rg, ref["grad"]["float32"][1], dev)
            out["grad_diag"][dtype] = d
            out["grad_rel"][dtype] = (abs(loss - rloss) / abs(rloss),
                                      d["max_rel"])

    with _lmm_first_grad(out["grad"], "float32", rank), \
            _lmm_vocab_blocks(out["vocab_blocks"]):
        state, losses, ms = _lmm_steps(torch, f32, tc, state, batches[:2])
    out["f32_ms"] = ms
    out["losses"] = losses
    note(f"sharded float32 steps {ms}, vocabulary blocks "
         f"{out['vocab_blocks']}")
    grad_rel("float32")
    t = time.perf_counter()
    from repro_torch.train import checkpoint as ckpt_mod
    ckpt_mod.save(ckpt_dir, 2, state)
    out["save_s"] = time.perf_counter() - t
    note("saved")
    out["f32_s"] = time.perf_counter() - t0

    # 3. resume on (4, 1): the state after step 2 through the checkpoint,
    # held to the unsharded run's; then one more step, held the same way
    t0 = time.perf_counter()
    mesh41 = RankMesh(LMM_RESHARD, ("data", "model"), device=dev.type)
    sh41 = TS.state_shardings(f32, tc, mesh41)
    lc = loop_mod.LoopConfig(checkpoint_dir=ckpt_dir)
    template = T.map(lambda x: 0, state)    # the tree's structure alone
    del state
    torch.cuda.empty_cache()
    back = loop_mod.resume_or_init(lc, template, shardings=sh41)
    out["restore_s"] = time.perf_counter() - t0
    note("restored")
    out["err_step2"] = _lmm_rel(torch, back, ref.get("step2"), rank)
    back, loss3, _ = _lmm_steps(torch, f32, tc, back, batches[2:])
    out["losses"] += loss3
    note("resumed step 3")
    out["err_step3"] = _lmm_rel(torch, back, ref.get("step3"), rank)
    del back
    for k in ("step2", "step3"):    # rank 0's kept states, before the peaks
        ref.pop(k, None)
    torch.cuda.empty_cache()
    out["reshard_s"] = time.perf_counter() - t0

    # 4. bf16 on (2, 2), timed; the staged collectives counted a step
    t0 = time.perf_counter()
    sh = TS.state_shardings(bf16, tc, mesh)
    state = shd.distribute(TS.init_state(tc, _lmm_params(torch, bf16, dev)),
                           sh)
    torch.cuda.empty_cache()
    with _lmm_first_grad(out["grad"], "bfloat16", rank):
        state, _, _ = _lmm_steps(torch, bf16, tc, state, batches[:1])
    grad_rel("bfloat16")
    torch.cuda.empty_cache()
    collectives.reset_staged_counts()
    torch.cuda.reset_peak_memory_stats()
    collectives.barrier()
    state, _, ms = _lmm_steps(torch, bf16, tc, state,
                              batches[1:1 + LMM_TIMED])
    out["bf16_ms"] = ms
    out["bf16_peak"] = torch.cuda.max_memory_allocated()
    out["staged_per_step"] = {k: [c / LMM_TIMED, b / LMM_TIMED] for k, (c, b)
                              in collectives.staged_counts().items()}
    del state
    torch.cuda.empty_cache()
    out["bf16_s"] = time.perf_counter() - t0
    note(f"sharded bf16 steps {ms}")

    # 5. olmoe-1b-7b, one layer: the loss on (2, 2)
    t0 = time.perf_counter()
    psh = shd.param_shardings(transformer.model_specs(moe), mesh,
                              shd.ShardingPolicy())
    prm = shd.distribute(_lmm_params(torch, moe, dev), psh)
    torch.cuda.empty_cache()
    from repro_torch.distributed import autoshard
    with torch.no_grad(), autoshard.use(mesh):
        loss, _ = transformer.loss_fn(
            moe, prm, TS.batch_on(moe_batch, dev, mesh),
            num_groups=shd.moe_groups(moe, mesh))
    out["moe_loss"] = float(shd.gather(loss))
    del prm, loss
    torch.cuda.empty_cache()
    out["moe_s"] = time.perf_counter() - t0
    note("olmoe loss")
    if rank == 0:
        out["ref"] = {k: v for k, v in ref.items()
                      if "step" not in k and k != "grad"}
    return out


def phase_lm_mesh(torch, np, smi: str):
    """The LM half of the mesh on the card: 4 ``torch.distributed`` ranks
    (``repro_torch.launch.ranks.spawn``) lay a train state over a
    (data, model) mesh by the reference's rules (FSDP over data, TP / EP
    over model) as DTensors. On one card the 4 ranks share ``cuda:0``
    over the staged backend (gloo through pinned host memory: NCCL
    refuses two ranks on one GPU, and DTensor's collectives on CUDA
    tensors over gloo never return); with 4 or more cards, NCCL, a card
    a rank. No CUDA kernel of its own.

    gemma3-1b at full width (d_model 1152, vocab 262144, 4 heads with
    one kv head, d_ff 6912, head_dim 256), depth cut to one super-block
    (6 of 26 layers), B = 4 x S = 1024 from ``data.synthetic``, the
    default AdamW (warm-up 100), layers drawn with their own fan-in:

    1. rank 0 runs the unsharded port on the same card first (3 float32
       steps, 1 + 1 timed bf16 steps, olmoe's loss);
    2. float32 on (2, 2): the vocabulary-parallel loss at the initial
       parameters, each rank's block of the logits V / 2 wide, the loss
       and the (tied) embedding's gradient within 1e-5 relative of the
       unsharded port's (bf16 in 4: the loss within 3e-2, the gradient
       no further from the float32 one than 1.5 times the unsharded
       bf16 gradient is); 2 steps, the losses within
       1e-5 relative of the unsharded ones; each rank holds under half
       the parameters; a checkpoint written collectively;
    3. resume on (4, 1) (``loop.resume_or_init(..., shardings=)``):
       every parameter and moment within 1e-4 of its leaf's range of the
       unsharded state after step 2; one more step, held the same way
       to the unsharded third (the restore's bitwise check is the CPU
       tests'; here it would cost a phase that must end in 120 s);
    4. bf16 on (2, 2): 1 + 1 timed step, against the unsharded ones
       (ms a step, each rank's peak beside the 12.1 GiB it took with the
       vocabulary whole in the loss, the staged collectives a step);
    5. olmoe-1b-7b at full width, one layer, on (2, 2): the loss against
       the unsharded port's at the same dispatch groups (2)."""
    import shutil
    import tempfile

    from repro_torch.launch import ranks

    ck = tempfile.mkdtemp(prefix="lm_mesh_ckpt_")
    t = time.perf_counter()
    try:
        outs = ranks.spawn(_lm_mesh_rank, 4, (ck,), device="cuda",
                           timeout_s=LMM_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"lm_mesh: {e}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    wall = time.perf_counter() - t
    r0 = outs[0]
    ref = r0["ref"]
    print(f"lm_mesh [{smi}]: {LMM_ARCH} full width, {LMM_LAYERS} of 26 "
          f"layers (cut: one super-block), B {LMM_B} x S {LMM_S}; 4 ranks "
          f"on {sorted({o['device'] for o in outs})}, backend "
          f"{r0['backend']}; spawn {wall:.2f} s (reference "
          f"{r0['ref_s']:.2f} s, f32 {r0['f32_s']:.2f} s incl. save "
          f"{r0['save_s']:.2f} s, reshard {r0['reshard_s']:.2f} s incl. "
          f"restore {r0['restore_s']:.2f} s, bf16 {r0['bf16_s']:.2f} s, "
          f"olmoe {r0['moe_s']:.2f} s)", flush=True)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(r0["losses"], ref["losses"]))
    print(f"lm_mesh [{smi}]: float32 losses sharded "
          + ", ".join(f"{x:.7f}" for x in r0["losses"])
          + " vs unsharded " + ", ".join(f"{x:.7f}" for x in ref["losses"])
          + f" (max rel {loss_err:.3e}); leaves after step 2 on {LMM_MESH}, "
          f"saved and restored on {LMM_RESHARD}: max rel "
          f"{r0['err_step2']:.3e}; after step 3 there "
          f"{r0['err_step3']:.3e}", flush=True)
    check(all(np.isfinite(r0["losses"])), f"lm_mesh losses {r0['losses']}")
    check(loss_err <= LMM_LOSS_TOL, f"lm_mesh: sharded loss {loss_err:.3e}"
          " from the unsharded port's")
    check(r0["err_step2"] <= LMM_TOL and r0["err_step3"] <= LMM_TOL,
          f"lm_mesh: sharded state {r0['err_step2']:.3e} / "
          f"{r0['err_step3']:.3e} of a leaf's range from the unsharded")
    whole = r0["whole_elems"]
    for o in outs:
        check(o["local_elems"] < whole // 2,
              f"lm_mesh: rank {o['rank']} holds {o['local_elems']:,} of "
              f"{whole:,} parameters")
    V = _lmm_cfg(LMM_ARCH, LMM_LAYERS, "float32").vocab_size
    blocks = [o["vocab_blocks"] for o in outs]
    print(f"lm_mesh [{smi}]: vocabulary-parallel loss on {LMM_MESH}: local "
          f"vocabulary blocks a rank {blocks} of V = {V:,}; loss / "
          "embedding gradient vs the unsharded port: " + ", ".join(
              f"{d} {a:.3e} / {b:.3e}"
              for d, (a, b) in sorted(r0["grad_rel"].items())), flush=True)
    for d, diag in sorted(r0["grad_diag"].items()):
        print(f"lm_mesh [{smi}]: {d} embedding gradient: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in diag.items()), flush=True)
    for o, b in zip(outs, blocks):
        check(b and all(w == V // LMM_MESH[1] for w in b),
              f"lm_mesh: rank {o['rank']}'s loss blocks {b}, not V / "
              f"{LMM_MESH[1]} = {V // LMM_MESH[1]}")
    check(sorted(r0["grad_rel"]) == ["bfloat16", "float32"],
          f"lm_mesh: gradients compared {sorted(r0['grad_rel'])}")
    for d, (a, b) in r0["grad_rel"].items():
        check(a <= (LMM_LOSS_TOL if d == "float32" else LMM_GRAD_TOL[d]),
              f"lm_mesh: {d} loss {a:.3e} from the unsharded port's")
    check(r0["grad_rel"]["float32"][1] <= LMM_GRAD_TOL["float32"],
          f"lm_mesh: float32 embedding gradient "
          f"{r0['grad_rel']['float32'][1]:.3e} from the unsharded port's")
    bd = r0["grad_diag"]["bfloat16"]
    check(bd["got_vs_f32_max_rel"]
          <= LMM_BF16_GRAD_FACTOR * bd["ref_vs_f32_max_rel"],
          f"lm_mesh: bf16 embedding gradient {bd['got_vs_f32_max_rel']:.3e}"
          f" from the float32 one, the unsharded bf16 "
          f"{bd['ref_vs_f32_max_rel']:.3e}")
    moe_err = abs(r0["moe_loss"] - ref["moe_loss"]) / abs(ref["moe_loss"])
    print(f"lm_mesh [{smi}]: {LMM_MOE} full width, 1 layer, on {LMM_MESH}: "
          f"loss {r0['moe_loss']:.7f} vs unsharded {ref['moe_loss']:.7f} "
          f"(rel {moe_err:.3e})", flush=True)
    check(moe_err <= LMM_LOSS_TOL, f"lm_mesh: olmoe loss {moe_err:.3e}")
    sharded = sorted(ms for o in outs for ms in o["bf16_ms"])
    print(f"lm_mesh [{smi}]: bf16 step, {LMM_TIMED} timed: sharded "
          f"{LMM_MESH} " + ", ".join(f"{x:.1f}" for x in r0["bf16_ms"])
          + " ms (rank 0), unsharded " + ", ".join(
              f"{x:.1f}" for x in r0["plain_bf16_ms"])
          + f" ms; f32 sharded steps " + ", ".join(
              f"{x:.1f}" for x in r0["f32_ms"]) + " ms; peak "
          + ", ".join(f"rank {o['rank']} {o['bf16_peak'] / 2**30:.2f} GiB"
                      for o in outs)
          + f" (the vocabulary whole in the loss: {LMM_WHOLE_VOCAB_PEAK_GIB} "
          f"GiB a rank), unsharded {r0['plain_peak'] / 2**30:.2f} "
          "GiB; parameters "
          "held a rank " + ", ".join(f"{o['local_elems']:,}" for o in outs)
          + f" of {whole:,}", flush=True)
    print(f"lm_mesh [{smi}]: staged collectives a bf16 step (rank 0: "
          "calls, bytes in): " + (", ".join(
              f"{k} {c:.0f} / {b:,.0f}" for k, (c, b) in
              sorted(r0["staged_per_step"].items())) or "none (NCCL)"),
          flush=True)
    print(json.dumps({"lm_mesh": {
        "card": smi, "backend": r0["backend"], "bf16_ms": r0["bf16_ms"],
        "plain_bf16_ms": r0["plain_bf16_ms"], "f32_ms": r0["f32_ms"],
        "peak_bytes": [o["bf16_peak"] for o in outs],
        "plain_peak_bytes": r0["plain_peak"],
        "staged_per_step": r0["staged_per_step"],
        "loss_rel": loss_err, "state_rel": [r0["err_step2"],
                                            r0["err_step3"]],
        "vocab_blocks": blocks, "grad_rel": r0["grad_rel"],
        "grad_diag": r0["grad_diag"],
        "moe_loss_rel": moe_err, "wall_s": wall}}), flush=True)


LMS_ARCH = "gemma3_1b"
LMS_LAYERS = 6                  # one super-block of gemma3-1b's 26 layers
LMS_B, LMS_S, LMS_NEW = 4, 4096, 16
LMS_MESH = (2, 2)               # (data, model)
LMS_MOE, LMS_MOE_S, LMS_MOE_NEW = "olmoe_1b_7b", 256, 2
LMS_SSD, LMS_SSD_LAYERS, LMS_SSD_S = "mamba2_780m", 2, 512
LMS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LMS_F64_TOL = 1e-9              # the float64 SGD updates, sharded vs not
# the float32 SGD updates, sharded vs not, at most this many times the
# unsharded float32 updates' distance from the float64 ones (two float32
# results, each within that distance of the float64 one, differ by up to
# twice it). An update read back from float32 parameters is rounded to
# the parameter's spacing: a norm scale near 1 moved by a few hundred of
# its ulps misses by one of them, a few 1e-3 of the update's range.
LMS_F32_FACTOR = 4.0
LMS_TIMEOUT_S = 120.0           # the phase's limit


def _lms_serve(torch, cfg, mesh, params, prompts, new, groups=1):
    """``launch/dryrun.build_cell``'s prefill, then its decode cell for
    each column of ``new``, on ``mesh`` (every rank); without a mesh the
    port's plain prefill and decode_step at ``groups`` MoE dispatch
    groups (the mesh's, which the cells use). Returns (the logits of every
    step, whole on every rank; prefill ms; decode ms a step), the times
    on the host's clock around synchronised calls."""
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    B, S = prompts.shape
    max_seq = S + new.shape[1]
    out = []

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def whole(x):
        # numpy: a rank's result crosses to the parent by pickle
        return shd.gather(x).float().cpu().numpy()

    sync()
    t = time.perf_counter()
    if mesh is None:
        dev = T.leaves(params)[0].device
        logits, cache = transformer.prefill(
            cfg, params, {"tokens": prompts.to(dev)}, max_seq,
            num_groups=groups)
    else:
        pre = ShapeConfig("lms", max_seq, B, "prefill")
        with dryrun.serving(cfg, pre, mesh):
            fn, args = dryrun.build_cell(cfg, pre, mesh, params=params,
                                         batch={"tokens": prompts})
            logits, cache = fn(*args)
        params = args[0]
    sync()
    pre_ms = 1e3 * (time.perf_counter() - t)
    out.append(whole(logits))
    dec = ShapeConfig("lms", max_seq, B, "decode")
    ms = []
    for i in range(new.shape[1]):
        batch = {"token": new[:, i:i + 1], "pos": S + i}
        sync()
        t = time.perf_counter()
        if mesh is None:
            batch["token"] = batch["token"].to(dev)
            logits, cache = transformer.decode_step(cfg, params, batch,
                                                    cache, num_groups=groups)
        else:
            with dryrun.serving(cfg, dec, mesh):
                fn, args = dryrun.build_cell(cfg, dec, mesh, params=params,
                                             batch=batch, cache=cache)
                logits, cache = fn(*args)
        sync()
        ms.append(1e3 * (time.perf_counter() - t))
        out.append(whole(logits))
    return out, pre_ms, ms


def _lms_rank(rank, world, dev_type, spec):
    """One rank of phase ``lm_mesh_serve`` (the docstring of
    :func:`phase_lm_mesh_serve` says what it does). ``spec`` holds the
    configs' names and sizes (smaller to rehearse on the CPU). Returns
    what this rank measured; rank 0 also what it checked against."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    cuda = dev.type == "cuda"
    mesh = RankMesh(spec["mesh"], ("data", "model"), device=dev_type)
    rng = np.random.default_rng(SEED)
    out = {"rank": rank, "device": str(dev)}
    start = time.perf_counter()

    def note(what):
        if rank == 0:
            print(f"lm_mesh_serve rank 0 at "
                  f"{time.perf_counter() - start:.1f} s: {what}",
                  file=sys.stderr, flush=True)

    def peak_reset():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    def cfg_of(arch, layers, dtype):
        c = spec["configs"][arch]
        return dataclasses.replace(c, n_layers=layers, compute_dtype=dtype)

    # 1. the dense model, float32 and bf16, with the sequence-parallel
    # decode policy (B < 16): the unsharded port on rank 0 first
    base = cfg_of(spec["arch"], spec["layers"], "float32")
    prompts = torch.from_numpy(rng.integers(
        0, base.vocab_size, (spec["B"], spec["S"])))
    new = torch.from_numpy(rng.integers(
        0, base.vocab_size, (spec["B"], spec["new"])))
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_of(spec["arch"], spec["layers"], dtype)
        cd = getattr(torch, dtype)
        params = T.map(lambda x: x.to(cd),
                       _per_layer_init(torch, cfg, _lm_model(
                           torch, cfg, SEED, dev)))
        if rank == 0:
            out[f"ref_{dtype}"], out[f"plain_prefill_ms_{dtype}"], \
                out[f"plain_decode_ms_{dtype}"] = _lms_serve(
                    torch, cfg, None, params, prompts, new)
            note(f"unsharded {dtype}")
        collectives.barrier()
        collectives.reset_staged_counts()
        peak_reset()
        got, out[f"prefill_ms_{dtype}"], out[f"decode_ms_{dtype}"] = \
            _lms_serve(torch, cfg, mesh, params, prompts, new)
        out[f"peak_{dtype}"] = peak()
        out[f"staged_{dtype}"] = collectives.staged_counts()
        if rank == 0:
            out[f"got_{dtype}"] = got
        del params, got
        note(f"sharded {dtype}")

    # 2. the MoE model, one layer, experts over data: the logits at the
    # same dispatch groups, and the routing integers of the prefill
    cfg = cfg_of(spec["moe"], 1, "float32")
    params = _per_layer_init(torch, cfg, _lm_model(torch, cfg, SEED, dev))
    mp = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                       (spec["B"], spec["moe_S"])))
    mn = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                       (spec["B"], spec["moe_new"])))

    @contextlib.contextmanager
    def spy(seen):
        orig = moe_mod.route

        def route(cfg, p, xt):
            r = orig(cfg, p, xt)
            seen.append((r.expert_idx, r.pos, r.keep))
            return r

        moe_mod.route = route
        try:
            yield
        finally:
            moe_mod.route = orig

    if rank == 0:
        # the unsharded run at the mesh's dispatch groups
        seen = []
        with spy(seen):
            out["moe_ref"], _, _ = _lms_serve(
                torch, cfg, None, params, mp, mn,
                groups=shd.moe_groups(cfg, mesh))
        out["moe_ref_routing"] = [x.cpu().numpy() for x in seen[0]]
    collectives.barrier()
    seen = []
    with spy(seen):
        got, out["moe_prefill_ms"], out["moe_decode_ms"] = _lms_serve(
            torch, cfg, mesh, params, mp, mn)
    routing = [shd.gather(x).cpu().numpy() for x in seen[0]]
    if rank == 0:
        out["moe_got"], out["moe_routing"] = got, routing
    del params
    note("olmoe")

    # 3. the SSD model: one SGD step sharded (the training policy)
    # against the unsharded one on rank 0, on one batch: at float32 the
    # loss, and each leaf's update (lr x its clipped gradient) against
    # the unsharded float32 one and against the float64 one, beside the
    # unsharded float32 updates against the float64 ones (the float32
    # rounding the sharded run is held to); at float64 each leaf's update
    tc = TS.TrainConfig(opt=opt_mod.OptConfig(
        name="sgd", lr=1e-2, warmup_steps=1, schedule="constant"))
    sh = None
    upd = {}
    cfg = cfg_of(spec["ssd"], spec["ssd_layers"], "float32")
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (spec["B"], spec["ssd_S"])
                                    ).astype(np.int32)}
    for dtype in ("float32", "float64"):
        cfg = cfg_of(spec["ssd"], spec["ssd_layers"], dtype)
        params = _per_layer_init(torch, cfg, _lm_model(torch, cfg, SEED,
                                                       dev))
        if dtype == "float64":
            params = T.map(lambda x: x.double(), params)
        init = [x.detach().to("cpu", copy=True) for x in T.leaves(params)]
        if rank == 0:
            state, m = TS.train_step(cfg, tc, TS.init_state(tc, T.map(
                torch.clone, params)), batch)
            out[f"ssd_ref_loss_{dtype}"] = float(m["loss"])
            ref_leaves = [a - b for a, b in
                          zip(_lmm_host(torch, state.params), init)]
            del state
        collectives.barrier()
        sh = TS.state_shardings(cfg, tc, mesh)
        state = shd.distribute(TS.init_state(tc, params), sh)
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = TS.train_step(cfg, tc, state, batch, donate=True)
        out[f"ssd_loss_{dtype}"] = float(m["loss"])
        if cuda:
            torch.cuda.synchronize()
        out[f"ssd_step_ms_{dtype}"] = 1e3 * (time.perf_counter() - t)
        paths = [p for p, _ in _paths(state.params)]
        got_leaves = []
        for x, x0 in zip(T.leaves(state.params), init):
            whole = shd.gather(x)
            if rank == 0:
                got_leaves.append(whole.cpu() - x0)
        if rank == 0:
            out[f"ssd_err_{dtype}"], out[f"ssd_worst_{dtype}"] = _lms_worst(
                torch, got_leaves, ref_leaves, paths)
            upd[dtype] = (ref_leaves, got_leaves)
        del state, params, got_leaves
    if rank == 0:
        (u32, s32), (u64, _) = upd["float32"], upd["float64"]
        out["ssd_base_float32"], out["ssd_base_worst"] = _lms_worst(
            torch, u32, u64, paths)
        out["ssd_f32_vs_f64"], out["ssd_f32_vs_f64_worst"] = _lms_worst(
            torch, s32, u64, paths)
    del upd
    note("mamba2 train step")
    out["wall_s"] = time.perf_counter() - start
    return out


def _lms_worst(torch, got, want, paths) -> tuple:
    """(max over leaves of max |got - want| / max |want|, that leaf's
    path)."""
    errs = [_lmm_rel_host(torch, g, w) for g, w in zip(got, want)]
    i = max(range(len(errs)), key=errs.__getitem__)
    return errs[i], paths[i]


def _paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts, in ``tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _lms_spec(dev: str) -> dict:
    from repro_torch import configs

    names = (LMS_ARCH, LMS_MOE, LMS_SSD)
    return {"arch": LMS_ARCH, "layers": LMS_LAYERS, "B": LMS_B,
            "S": LMS_S, "new": LMS_NEW, "mesh": LMS_MESH, "moe": LMS_MOE,
            "moe_S": LMS_MOE_S, "moe_new": LMS_MOE_NEW, "ssd": LMS_SSD,
            "ssd_layers": LMS_SSD_LAYERS, "ssd_S": LMS_SSD_S,
            "configs": {a: configs.get_config(a) for a in names}}


def phase_lm_mesh_serve(torch, np, ce, fb, smi: str, dev: str = "cuda",
                        spec: dict = None):
    """Sharded serving and the dry run's TM slab on the card. 4
    ``torch.distributed`` ranks (``launch.ranks.spawn``; on one card the
    staged backend, as phase ``lm_mesh``) run ``launch/dryrun.build_cell``'s
    serving cells, the same code the dry run traces, and the ranks' own
    blocks of the KV cache (``cache_shardings``) are written and read in
    place:

    1. gemma3-1b at full width, one super-block (6 of 26 layers), B = 4
       prompts of 4096 tokens plus 16 new tokens given, on (2, 2) under
       the serving policy with sequence parallelism (decode with B < 16):
       the GLOBAL cache's sequence over ``model`` (the partial-softmax
       decode), the LOCAL windows' head_dim over ``model``; float32 and
       bf16 each held to the unsharded port on the same card (logits
       within LMS_TOL of max |ref|, greedy tokens equal or at a near-tie);
    2. olmoe-1b-7b at full width, one layer, experts over ``data``: the
       logits of a 256-token prefill and 2 decode steps at the mesh's 2
       dispatch groups, and the prefill's routing integers, against the
       unsharded port at the same groups;
    3. mamba2-780m at full width, 2 layers: one sharded SGD step (the
       chunk views over ``model``) against the unsharded one on one
       batch: the float32 loss within 1e-5 relative; each leaf's float32
       update (lr x gradient) within LMS_F32_FACTOR times the unsharded
       float32 updates' own distance from the float64 ones (an update
       read back from float32 parameters near 1 is rounded to their
       spacing), and at float64 compute within 1e-9 of its range;
    4. the dry run's TM cell: slab 0 of the 8192-replica grid (32
       replicas, 10 epochs) through K3/K4/K9, with its peak; the kernels'
       counts are set to 0 just before and must have moved just after.

    Prints prefill ms, decode ms a step, each rank's peak and the staged
    collectives a step; no kernel of its own."""
    import tempfile

    from repro_torch.launch import dryrun, ranks

    spec = spec or _lms_spec(dev)
    t = time.perf_counter()
    try:
        outs = ranks.spawn(_lms_rank, 4, (dev, spec), device=dev,
                           timeout_s=LMS_TIMEOUT_S, staged=dev == "cpu")
    except RuntimeError as e:
        fail(f"lm_mesh_serve: {e}")
    wall = time.perf_counter() - t
    r0 = outs[0]
    report = {"card": smi, "wall_s": wall, "ranks_wall_s": r0["wall_s"]}
    for dtype in ("float32", "bfloat16"):
        got = [torch.from_numpy(x) for x in r0[f"got_{dtype}"]]
        want = [torch.from_numpy(x) for x in r0[f"ref_{dtype}"]]
        errs = [((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
        for g in got:
            check(bool(torch.isfinite(g).all()),
                  f"lm_mesh_serve {dtype}: non-finite logits")
        tol = LMS_TOL[dtype]
        check(max(errs) <= tol, f"lm_mesh_serve {dtype}: logits "
              f"{max(errs):.3e} of max|ref| from the unsharded port")
        gt = np.stack([g.argmax(-1).numpy() for g in got], 1)
        wt = np.stack([w.argmax(-1).numpy() for w in want], 1)
        for b in range(gt.shape[0]):
            for i in np.nonzero(gt[b] != wt[b])[0]:
                top2 = torch.topk(want[i][b], 2).values
                gap = (top2[0] - top2[1]).item()
                check(gap <= tol * want[i][b].abs().max().item(),
                      f"lm_mesh_serve {dtype}: row {b} step {i} token "
                      f"{gt[b, i]} vs {wt[b, i]} at a top-2 gap {gap}")
        dec = [ms for o in outs for ms in o[f"decode_ms_{dtype}"][1:]]
        report[dtype] = {
            "logits_rel": max(errs),
            "prefill_ms": r0[f"prefill_ms_{dtype}"],
            "decode_ms": r0[f"decode_ms_{dtype}"],
            "plain_prefill_ms": r0[f"plain_prefill_ms_{dtype}"],
            "plain_decode_ms": r0[f"plain_decode_ms_{dtype}"],
            "peak_bytes": [o[f"peak_{dtype}"] for o in outs],
            "staged_per_step": {k: [c / (1 + LMS_NEW), b / (1 + LMS_NEW)]
                                for k, (c, b) in
                                r0[f"staged_{dtype}"].items()}}
        print(f"lm_mesh_serve [{smi}]: {spec['arch']} full width, "
              f"{spec['layers']} layers, B {spec['B']} x {spec['S']} + "
              f"{spec['new']} on {spec['mesh']} ({dtype}): logits max rel "
              f"{max(errs):.3e}; prefill {r0[f'prefill_ms_{dtype}']:.1f} ms "
              f"(unsharded {r0[f'plain_prefill_ms_{dtype}']:.1f}); decode "
              f"median {np.median(r0[f'decode_ms_{dtype}'][1:]):.1f} ms a "
              f"step, min-max {min(dec):.1f}-{max(dec):.1f} over ranks "
              f"(unsharded median "
              f"{np.median(r0[f'plain_decode_ms_{dtype}'][1:]):.1f}); peak "
              + ", ".join(f"{p / 2**30:.2f}" for p in
                          report[dtype]["peak_bytes"]) + " GiB", flush=True)
        print(f"lm_mesh_serve [{smi}]: staged collectives a step ({dtype}, "
              "rank 0: calls, bytes in): " + (", ".join(
                  f"{k} {c:.1f} / {b:,.0f}" for k, (c, b) in sorted(
                      report[dtype]["staged_per_step"].items()))
                  or "none (NCCL)"), flush=True)
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(r0["moe_got"], r0["moe_ref"])]
    check(max(errs) <= LMS_TOL["float32"],
          f"lm_mesh_serve olmoe: logits {max(errs):.3e}")
    for g, w, name in zip(r0["moe_routing"], r0["moe_ref_routing"],
                          ("expert_idx", "pos", "keep")):
        check(np.array_equal(g, w), f"lm_mesh_serve olmoe: routing {name}")
    report["olmoe"] = {"logits_rel": max(errs),
                       "prefill_ms": r0["moe_prefill_ms"],
                       "decode_ms": r0["moe_decode_ms"]}
    print(f"lm_mesh_serve [{smi}]: {spec['moe']} full width, 1 layer, "
          f"experts over data: logits max rel {max(errs):.3e}, routing "
          f"integers equal; prefill {r0['moe_prefill_ms']:.1f} ms, decode "
          + ", ".join(f"{x:.1f}" for x in r0["moe_decode_ms"]) + " ms",
          flush=True)
    loss_err = abs(r0["ssd_loss_float32"] - r0["ssd_ref_loss_float32"]) \
        / abs(r0["ssd_ref_loss_float32"])
    check(loss_err <= LMM_LOSS_TOL, f"lm_mesh_serve mamba2: loss "
          f"{loss_err:.3e}")
    check(r0["ssd_err_float64"] <= LMS_F64_TOL, f"lm_mesh_serve mamba2: "
          f"float64 updates {r0['ssd_err_float64']:.3e} of a leaf's range "
          f"({r0['ssd_worst_float64']})")
    check(r0["ssd_err_float32"] <= LMS_F32_FACTOR * r0["ssd_base_float32"],
          f"lm_mesh_serve mamba2: float32 updates, sharded vs not, "
          f"{r0['ssd_err_float32']:.3e} of a leaf's range "
          f"({r0['ssd_worst_float32']}) > {LMS_F32_FACTOR} x the unsharded "
          f"float32's distance from float64, {r0['ssd_base_float32']:.3e} "
          f"({r0['ssd_base_worst']})")
    report["mamba2"] = {
        "loss_rel": loss_err, "update_rel_f64": r0["ssd_err_float64"],
        "update_rel_f32": r0["ssd_err_float32"],
        "unsharded_f32_vs_f64": r0["ssd_base_float32"],
        "sharded_f32_vs_f64": r0["ssd_f32_vs_f64"],
        "step_ms": [o["ssd_step_ms_float32"] for o in outs]}
    print(f"lm_mesh_serve [{smi}]: {spec['ssd']} full width, "
          f"{spec['ssd_layers']} layers, one SGD step on {spec['mesh']}: "
          f"float32 loss rel {loss_err:.3e}; float32 updates, sharded vs "
          f"not, {r0['ssd_err_float32']:.3e} of a leaf's range "
          f"({r0['ssd_worst_float32']}); unsharded float32 vs float64 "
          f"{r0['ssd_base_float32']:.3e} ({r0['ssd_base_worst']}); sharded "
          f"float32 vs float64 {r0['ssd_f32_vs_f64']:.3e} "
          f"({r0['ssd_f32_vs_f64_worst']}); float64 updates, sharded vs "
          f"not, {r0['ssd_err_float64']:.3e}; float32 step "
          + ", ".join(f"{o['ssd_step_ms_float32']:.1f}" for o in outs)
          + " ms", flush=True)

    # 4. the TM slab: launches counted from 0
    zero_counters(ce, fb)
    with tempfile.TemporaryDirectory() as tmp:
        tm = dryrun.run_tm_cell("single", tmp, device=dev)
    got = counters(ce, fb)
    if dev != "cpu":
        for name in ("clause_counts_replicated",
                     "clause_counts_batch_replicated",
                     "feedback_plane_replicated"):
            check(got.get(name, 0) > 0, f"lm_mesh_serve: the TM slab never "
                  f"launched {name}")
    report["tm_slab"] = {"replicas": tm["replicas_per_device"],
                         "peak_bytes": tm["memory"]["temp_size_in_bytes"],
                         "slab_s": tm["slab_s"], "launches": got}
    print(f"lm_mesh_serve [{smi}]: dry-run TM slab ({tm['replicas']} "
          f"replicas over {tm['n_devices']}, slab 0 = "
          f"{tm['replicas_per_device']}) in {tm['slab_s']:.2f} s, peak "
          f"{tm['memory']['temp_size_in_bytes'] / 2**20:.2f} MiB, launches "
          f"{got}", flush=True)
    print(json.dumps({"lm_mesh_serve": report}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-from", type=Path, metavar="DIR",
                    help="import repro_torch from DIR (a tree's src/), run "
                    "only the device, build, parity and parity_replicated "
                    "phases, the launch floor and the K7 byte timings, "
                    "and stop (no ok line)")
    ap.add_argument("--tm-from", type=Path, metavar="DIR",
                    help="import repro_torch from DIR (a tree's src/), run "
                    "only the device, build, fleet, fleet_iris, tunable, "
                    "residency and profile_fleet phases (the TM service's "
                    "readings, to hold two trees against each other), and "
                    "stop (no ok line)")
    args = ap.parse_args()
    started = time.perf_counter()
    src = args.kernels_from or args.tm_from or ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources ({src}/repro_torch) are "
              "not there", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    from repro_torch.kernels import _build
    from repro_torch.kernels import clause_eval as ce
    from repro_torch.kernels import feedback as fb

    if not (args.kernels_from or args.tm_from):
        # the worker and rank processes of later phases fork from a
        # server that imports torch once; it starts now, beside the build
        from repro_torch.launch import ranks
        ranks.warm()
    t = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(p.name for p in built.values())} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.2f} s", flush=True)
        return out

    if args.tm_from:
        timed("fleet", phase_fleet, torch, np, ce, fb)
        timed("fleet_iris", phase_fleet_iris, torch, np, ce, fb)
        timed("tunable", phase_tunable, torch, np, ce, fb)
        timed("residency", phase_residency, torch, np, ce, fb)
        timed("profile_fleet", phase_profile_fleet, torch, np)
        return 0
    recs = timed("parity", phase_parity, torch, np, ce, fb)
    recs += timed("parity_replicated", phase_parity_replicated, torch, np,
                  ce, fb)
    print(f"launch floor: one-element add_ {launch_floor_ms(torch):.5f} ms",
          flush=True)
    if args.kernels_from:
        recs += timed("time_pruned_bytes", phase_time_pruned_bytes, torch,
                      np, ce)
        recs += timed("time_words", phase_time_words, torch, np, ce)
        serves = timed("time_serves", phase_time_serves, torch, np)
        print(json.dumps({"kernel_times": recs, "serve_ms": serves}),
              flush=True)
        return 0
    probe = timed("b1_probe", phase_b1_probe, torch, np)
    word_err = timed("parity_words", phase_parity_words, torch, np, ce)
    recs += timed("parity_packed", phase_parity_packed, torch, np, ce, probe,
                  word_err)
    recs += timed("parity_pruned", phase_parity_pruned, torch, np, ce, probe,
                  word_err)
    timed("one_launch", phase_one_launch, torch, np, ce)
    launches = timed("service", phase_main, torch, np, ce, fb)
    paper = timed("paper", phase_paper, torch, np, ce, fb)
    launches.update(timed("wide", phase_wide, torch, np, ce, fb))
    check(all(n > 0 for n in paper.values()),
          "a replica-first kernel never launched on the paper path")
    timed("examples", phase_examples, torch, np, ce, fb)
    launches.update(timed("fleet", phase_fleet, torch, np, ce, fb))
    timed("fleet_iris", phase_fleet_iris, torch, np, ce, fb)
    launches.update(timed("tunable", phase_tunable, torch, np, ce, fb))
    timed("residency", phase_residency, torch, np, ce, fb)
    timed("traffic", phase_traffic, torch, np, ce, fb)
    timed("mesh", phase_mesh, torch, np, ce, fb, smi)
    timed("lm", phase_lm, torch, np)
    timed("lm_train", phase_lm_train, torch, np)
    timed("lm_moe_ssd", phase_lm_moe_ssd, torch, np)
    timed("lm_moe_ssd_train", phase_lm_moe_ssd_train, torch, np)
    timed("lm_rglru_cross", phase_lm_rglru_cross, torch, np)
    timed("lm_rglru_cross_train", phase_lm_rglru_cross_train, torch, np)
    timed("lm_attention_memory", phase_lm_attention_memory, torch, np)
    timed("lm_mesh", phase_lm_mesh, torch, np, smi)
    timed("lm_mesh_serve", phase_lm_mesh_serve, torch, np, ce, fb, smi)
    timed("profile", phase_profile, torch, np)
    timed("profile_epoch", phase_profile_epoch, torch, np)
    timed("profile_fleet", phase_profile_fleet, torch, np)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]
    print(f"chip_smoke wall: {time.perf_counter() - started:.1f} s (the "
          "build included)", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
