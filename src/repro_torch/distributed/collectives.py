"""Gradient compression with error feedback, the twin of the reference's
``distributed/collectives.py``.

int8 quantised gradients (per-tensor max-abs scaling) with an error-feedback
residual, so the compression bias does not accumulate [Seide et al. 2014;
Karimireddy et al. 2019]. On one device nothing crosses a network: the step
quantises, dequantises and carries the residual, as the reference does
before its (sharding-boundary) reduction.

Given the same float32 inputs this is bitwise the reference's: ``round``
is half to even in both packages, and the scale is ``max(max|x|, 1e-12) /
127`` in float32, divided by a tensor (CUDA turns a division by a Python
scalar into a product with its reciprocal).
"""
from __future__ import annotations

import importlib
import math
import os
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class CompressionState(NamedTuple):
    residual: Any  # error-feedback tree, same structure as grads


def init_state(params) -> CompressionState:
    """Zero residuals laid out like their parameters."""
    return CompressionState(residual=T.map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / d127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, state: CompressionState
                   ) -> tuple[Any, CompressionState, dict]:
    """Quantise (grad + residual) to int8; return the dequantised grads, the
    new residuals and ``{"compress_err_l1": sum |residual|}``."""

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = _quantize_int8(g32)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    outs = [one(g, r) for g, r in zip(T.leaves(grads),
                                      T.leaves(state.residual))]
    new_g = T.unflatten(grads, [o[0] for o in outs])
    new_r = T.unflatten(grads, [o[1] for o in outs])
    err = sum(r.abs().sum() for r in T.leaves(new_r))
    return new_g, CompressionState(residual=new_r), {"compress_err_l1": err}


def mesh_of(shardings):
    """The mesh of a tree of ``NamedSharding`` (its first leaf's), or
    None."""
    leaf = next(iter(T.leaves(shardings)), None) if shardings is not None \
        else None
    return None if leaf is None else leaf.mesh


def agree(loss: float, seconds: float, mesh) -> tuple[float, float]:
    """One all-reduce (max) over the mesh's ranks of a step's loss, its
    non-finite flag and its time: every rank gets the same loss (NaN if
    any rank's is not finite) and the slowest rank's time, so the
    watchdog decides alike on every rank."""
    import torch.distributed as dist

    bad = 0.0 if math.isfinite(loss) else 1.0
    t = torch.tensor([bad, seconds, loss if bad == 0.0 else 0.0],
                     dtype=torch.float64, device=mesh.device)
    all_reduce(t, dist.ReduceOp.MAX)
    bad, seconds, loss = t.tolist()
    return (float("nan") if bad else loss), seconds


def _staged_world():
    """The world group when it is the staged backend's, else None."""
    import torch.distributed as dist

    world = dist.distributed_c10d._get_default_group()
    return world if _REGISTERED and isinstance(world, _REGISTERED[0]) \
        else None


def all_reduce(t: torch.Tensor, op) -> None:
    """``dist.all_reduce(t, op)`` over the world, in place; on the staged
    backend through its own method (c10d's API would look up a CUDA
    backend that a Python process group does not register)."""
    import torch.distributed as dist

    world = _staged_world()
    if world is not None:
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        world.allreduce([t], opts).wait()
    else:
        dist.all_reduce(t, op=op)


def barrier() -> None:
    """``dist.barrier()`` over the world (on the staged backend through
    its own method)."""
    import torch.distributed as dist

    world = _staged_world()
    if world is not None:
        world.barrier(dist.BarrierOptions()).wait()
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Collectives through pinned host memory (ranks that share a card)
# ---------------------------------------------------------------------------

# (collective -> [calls, bytes a rank sent into it]) of this process's
# staged collectives, for the chip smoke test to print.
STAGED: dict = {}


def staged_counts() -> dict:
    """A copy of :data:`STAGED`: ``{op: [calls, bytes]}``."""
    return {k: list(v) for k, v in STAGED.items()}


def reset_staged_counts() -> None:
    STAGED.clear()


def _count(op: str, *tensors) -> None:
    entry = STAGED.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += sum(t.numel() * t.element_size() for t in tensors)


def _c10d():
    import torch._C._distributed_c10d as c10d

    return c10d


def _done(result):
    from torch.futures import Future
    from torch._C._distributed_c10d import _create_work_from_future

    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat byte view of a contiguous tensor."""
    return t.reshape(-1).view(torch.uint8)


_REDUCE = {"SUM": torch.sum, "AVG": torch.mean,
           "MAX": lambda x, dim: torch.amax(x, dim=dim),
           "MIN": lambda x, dim: torch.amin(x, dim=dim),
           "PRODUCT": torch.prod}


def _op_name(op) -> str:
    import torch.distributed as dist

    for name in _REDUCE:
        if op == getattr(dist.ReduceOp, name):
            return name
    raise NotImplementedError(f"the staged backend does not reduce by {op}")


class _Board:
    """The ranks' shared staging area: a file every rank of a group maps
    (``torch.from_file(shared=True)``, host memory through the page
    cache), one slot of ``slot`` bytes a rank. A rank copies its part
    from its card into its slot, the group meets at a barrier (gloo, a
    few bytes), each rank copies what it needs from the slots onto its
    card (reducing in rank order, so every rank gets the same sum), and
    the group meets again before the slots are reused. Tensors larger
    than a slot go through in pieces."""

    SLOT = 64 << 20

    def __init__(self, store, rank: int, size: int, barrier):
        import tempfile

        self.rank, self.size, self._barrier = rank, size, barrier
        if rank == 0:
            fd, path = tempfile.mkstemp(prefix="repro_staged_")
            os.ftruncate(fd, size * self.SLOT)
            os.close(fd)
            store.set("board", path)
        path = store.get("board").decode()
        self.buf = torch.from_file(path, shared=True,
                                   size=size * self.SLOT, dtype=torch.uint8)
        barrier()
        if rank == 0:
            os.unlink(path)   # the mappings stay; nothing is left behind

    def slot(self, j: int, n: int = None) -> torch.Tensor:
        return self.buf[j * self.SLOT:j * self.SLOT + (self.SLOT if n is None
                                                        else n)]

    def exchange(self, parts_in, read):
        """One round in pieces: ``parts_in`` are this rank's k byte views
        of equal length L (k = 1: one part for every rank; k = size: part
        i for rank i); ``read(piece_off, n, views)`` gets, for each
        piece, ``views[j][i]``: rank j's part i (bytes [off, off + n))."""
        k = len(parts_in)
        length = parts_in[0].numel()
        step = max(1, self.SLOT // k)
        for off in range(0, max(length, 1), step):
            n = min(step, length - off)
            mine = self.slot(self.rank)
            for i, part in enumerate(parts_in):
                mine[i * n:(i + 1) * n].copy_(part[off:off + n])
            self._barrier()
            read(off, n, [[self.slot(j)[i * n:(i + 1) * n]
                           for i in range(k)] for j in range(self.size)])
            self._barrier()


def _staged_class():
    import torch.distributed as dist

    class StagedProcessGroup(dist.ProcessGroup):
        """The collectives DTensor issues, for ranks that share a card
        (NCCL refuses two ranks on one GPU, and DTensor's collectives on
        CUDA tensors over gloo never return, PERF.md): every input goes
        from the card into host memory that the group's ranks share
        (:class:`_Board`), and each rank takes what it needs back onto
        its card, before the call returns. Every call is counted in
        :data:`STAGED` with the bytes the rank put in."""

        def __init__(self, store, rank: int, size: int, timeout):
            super().__init__(rank, size)
            self._gloo = dist.ProcessGroupGloo(
                dist.PrefixStore("staged/", store), rank, size, timeout)
            self._board = _Board(
                dist.PrefixStore("board/", store), rank, size,
                lambda: self._gloo.barrier(dist.BarrierOptions()).wait())

        def getBackendName(self) -> str:
            return "staged"

        @property
        def group_name(self) -> str:
            # c10d returns a Python process group as the group itself and
            # names it in its registry only
            return dist.distributed_c10d._world.pg_names[self]

        def _reduce_into(self, dst, views, dtype, op):
            """``dst`` (bytes on the card) = the reduction over ranks of
            ``views`` (each rank's bytes), in rank order."""
            stacked = torch.stack([v.to(dst.device) for v in views]
                                  ).view(dtype).reshape(len(views), -1)
            red = _REDUCE[op](stacked, dim=0).to(dtype)
            dst.copy_(_bytes(red.contiguous()))

        def allreduce(self, tensors, opts=None):
            op = _op_name((opts or dist.AllreduceOptions()).reduceOp)
            for t in tensors:
                _count("all_reduce", t)
                x = t.contiguous()
                out = _bytes(x)

                def read(off, n, views, out=out, x=x):
                    self._reduce_into(out[off:off + n],
                                      [v[0] for v in views], x.dtype, op)

                self._board.exchange([_bytes(x)], read)
                if x.data_ptr() != t.data_ptr():
                    t.copy_(x)
            return _done(tensors)

        def allreduce_coalesced(self, tensors, opts=None):
            return self.allreduce(tensors, opts)

        def broadcast(self, tensors, opts=None):
            root = (opts or dist.BroadcastOptions()).rootRank
            for t in tensors:
                _count("broadcast", t)
                x = t.contiguous()
                out = _bytes(x)

                def read(off, n, views, out=out):
                    if self.rank() != root:
                        out[off:off + n].copy_(views[root][0])

                self._board.exchange([_bytes(x)], read)
                if x.data_ptr() != t.data_ptr():
                    t.copy_(x)
            return _done(tensors)

        def all_gather_single(self, output, input, opts=None):
            _count("all_gather", input)
            x = input.contiguous()
            out = _bytes(output) if output.is_contiguous() else None
            whole = out if out is not None else torch.empty(
                output.numel() * output.element_size(), dtype=torch.uint8,
                device=output.device)
            size = x.numel() * x.element_size()

            def read(off, n, views):
                for j, v in enumerate(views):
                    whole[j * size + off:j * size + off + n].copy_(v[0])

            self._board.exchange([_bytes(x)], read)
            if out is None:
                output.copy_(whole.view(output.dtype).view(output.shape))
            return _done(output)

        def allgather_into_tensor_coalesced(self, outputs, inputs,
                                            opts=None):
            for o, i in zip(outputs, inputs):
                self.all_gather_single(o, i, opts)
            return _done(outputs)

        def allgather(self, output_lists, inputs, opts=None):
            for outs, i in zip(output_lists, inputs):
                flat = torch.empty((len(outs),) + tuple(i.shape),
                                   dtype=i.dtype, device=i.device)
                self.all_gather_single(flat, i, opts)
                for o, piece in zip(outs, flat.unbind(0)):
                    o.copy_(piece)
            return _done(output_lists)

        def reduce_scatter_single(self, output, input, opts=None):
            _count("reduce_scatter", input)
            op = _op_name((opts or dist.ReduceScatterOptions()).reduceOp)
            x = _bytes(input.contiguous())
            n = self.size()
            parts = list(x.chunk(n)) if x.numel() else [x] * n
            o = output.contiguous()
            out = _bytes(o)
            me = self.rank()

            def read(off, m, views):
                self._reduce_into(out[off:off + m], [v[me] for v in views],
                                  o.dtype, op)

            self._board.exchange(parts, read)
            if o.data_ptr() != output.data_ptr():
                output.copy_(o)
            return _done(output)

        def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                            opts=None):
            for o, i in zip(outputs, inputs):
                self.reduce_scatter_single(o, i, opts)
            return _done(outputs)

        def reduce_scatter(self, outputs, input_lists, opts=None):
            for o, ins in zip(outputs, input_lists):
                self.reduce_scatter_single(o, torch.stack(
                    [t.reshape(o.shape) for t in ins]), opts)
            return _done(outputs)

        def all_to_all_single(self, output, input, output_split_sizes,
                              input_split_sizes, opts=None):
            if output_split_sizes or input_split_sizes:
                raise NotImplementedError(
                    "the staged backend's all-to-all takes equal splits")
            _count("all_to_all", input)
            n = self.size()
            parts = list(_bytes(input.contiguous()).chunk(n))
            o = output.contiguous()
            out = _bytes(o)
            size = out.numel() // n
            me = self.rank()

            def read(off, m, views):
                for j, v in enumerate(views):
                    out[j * size + off:j * size + off + m].copy_(v[me])

            self._board.exchange(parts, read)
            if o.data_ptr() != output.data_ptr():
                output.copy_(o)
            return _done(output)

        def barrier(self, opts=None):
            self._gloo.barrier(opts or dist.BarrierOptions()).wait()
            return _done(None)

    return StagedProcessGroup


def _shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
    """DTensor's Shard(i) -> Shard(j) move (``_dtensor::shard_dim_alltoall``)
    on a staged group: its CUDA kernel asks the group for a CUDA backend,
    which a Python process group does not register, so the staged
    backend serves it as DTensor does on the CPU: an all-gather along
    ``gather_dim`` (staged), then this rank's chunk along
    ``shard_dim``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name) \
        if isinstance(group_name, str) else group_name
    n, r = group.size(), dist.get_group_rank(group, dist.get_rank())
    x = input.contiguous()
    flat = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    # the staged group's own method: c10d's API would look up a CUDA
    # backend, which it does not register
    group.all_gather_single(flat, x, _c10d().AllgatherOptions())
    whole = torch.cat(list(flat.unbind(0)), dim=gather_dim)
    size = whole.shape[shard_dim] // n
    return whole.narrow(shard_dim, r * size, size).contiguous()


_REGISTERED = []


def register_staged_backend() -> str:
    """Register the ``"staged"`` backend (:func:`_staged_class`) for CPU
    and CUDA tensors, and its kernel of ``_dtensor::shard_dim_alltoall``
    for CUDA tensors, once a process; returns its name."""
    import torch.distributed as dist

    if not _REGISTERED:
        cls = _staged_class()
        dist.Backend.register_backend(
            "staged", lambda store, rank, size, timeout:
            cls(store, rank, size, timeout), devices=["cpu", "cuda"])
        _REGISTERED.append(cls)
        if torch.cuda.is_available():
            # importing DTensor's collectives defines the op
            importlib.import_module("torch.distributed.tensor._collective_utils")
            lib = torch.library.Library("_dtensor", "IMPL")
            lib.impl("shard_dim_alltoall", _shard_dim_alltoall, "CUDA")
            _REGISTERED.append(lib)
    return "staged"
