"""Start the ranks of a process group on one host.

:func:`spawn` starts ``world`` processes from a fork server
(:func:`context`), joins them to one world group through a file store
(:func:`~repro_torch.launch.mesh.init_ranks`, the backend by device and
card count), runs ``fn(rank, world, *args)`` in each and returns what each
returned. A rank that raises, or a spawn that outlives its timeout, fails
the call with every rank's error; the processes are stopped either way.
``fn`` must be importable by the children (a module-level function).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

# What a rank or worker process needs before anything else. The fork
# server imports it once and every process it forks starts with it loaded:
# where the file system is slow a fresh interpreter spends many seconds
# importing torch and DTensor, and four ranks import at once. The server
# runs nothing but these imports: none touches CUDA or runs a parallel
# region (numpy's BLAS pool is fork-aware), so a process forked from it can
# take a card, where one forked from the caller, with its threads and
# CUDA context, could not.
PRELOAD = ["__main__", "numpy", "torch", "torch.distributed.tensor"]


def context():
    """The multiprocessing context that ranks (and the callers' worker
    pools) start in: a fork server that has imported :data:`PRELOAD`. It
    starts at its first use (or :func:`warm`) and ends with the process
    that started it."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    return ctx


def warm() -> None:
    """Start the fork server now, so that its imports run beside the
    caller's own work instead of in front of the first process."""
    from multiprocessing import forkserver

    context()
    forkserver.ensure_running()


def _entry(fn, rank: int, world: int, init_method: str, device,
           staged: bool, args: tuple, out) -> None:
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_ranks

        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
        init_ranks(rank, world, init_method=init_method, device=device,
                   staged=staged)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, args: tuple = (), *, device="cuda",
          timeout_s: float = 120.0, staged: bool = False) -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks; returns the ranks'
    results in rank order. ``device`` is the ranks' ("cuda": ranks share
    the cards round-robin; "cpu": gloo); ``staged`` sends the CPU ranks'
    collectives through the staged backend (which ranks sharing a card
    use), so that the CPU tests cover it."""
    ctx = context()
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry, args=(
            fn, r, world, init, device, staged, tuple(args), out))
            for r in range(world)]
        for p in procs:
            p.start()
        results: dict = {}
        errors: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if errors and all(not p.is_alive() for p in procs):
                        break
                    continue
                (results if ok else errors)[rank] = value
        finally:
            for p in procs:
                p.join(timeout=5 if len(results) == world else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
    if len(results) < world:
        missing = [r for r in range(world)
                   if r not in results and r not in errors]
        lines = [f"rank {r}:\n{errors[r]}" for r in sorted(errors)]
        if missing:
            lines.append(f"ranks {missing} gave no result within "
                         f"{timeout_s:.0f} s")
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(lines))
    return [results[r] for r in range(world)]
