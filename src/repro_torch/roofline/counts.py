"""What one rank does in a step, counted op by op: the port's
counterpart of the reference's ``roofline/hlo_parse.py`` and
``roofline/hlo_cost.py``.

The reference parses the optimized HLO of a compiled cell. The port
emits no HLO, so :class:`Recorder` watches the step run instead: a torch
dispatch mode that sees every aten op the rank runs on its own tensors
(a DTensor op is passed on to DTensor, whose local ops and collectives
it then sees), and keeps

* FLOPs, by ``torch.utils.flop_counter``'s formulas on the local shapes
  (products, convolutions, attention);
* traffic bytes: each op's operand and result bytes (tensor granularity,
  as ``hlo_cost`` counts an instruction's; ops whose result is a view of
  an operand move nothing);
* collectives by op (the reference's names: all-gather, all-reduce,
  reduce-scatter, all-to-all, collective-permute): count, result bytes,
  and wire bytes by the ring factors of :func:`wire_factor` on the
  group's size, split by link: NVLink when the group's ranks sit in one
  node of :data:`NODE_GPUS` consecutive ranks, else the network;
* the live bytes of the tensors the step creates, and their peak, with
  the largest storages live there (the op that made each, its shape and
  dtype).

A loop runs its body's ops once an iteration, so a layer loop counts
each layer (what ``hlo_cost``'s trip counts restore for a scan).
Running under ``FakeTensorMode`` (the dry run) nothing is allocated and
the same counts come out.
"""
from __future__ import annotations

import dataclasses
import heapq
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVE = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
# the files of DTensor's sharding propagation, which runs an op on tensors
# of the global shape to learn its output's; none of that is the rank's
_PROPAGATION = ("_sharding_prop.py", "_op_schema.py")


def wire_factor(op: str, g: int, result_bytes: float) -> float:
    """Bytes a device sends for one collective of ``result_bytes`` over a
    group of ``g`` under ring algorithms (the reference's factors,
    ``hlo_cost._wire_factor``): all-reduce 2(g-1)/g, all-gather (g-1)/g
    of the gathered result, reduce-scatter (g-1) x the scattered shard,
    all-to-all (g-1)/g, a permute the bytes once."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if op == "all-gather":
        return (g - 1) / g * result_bytes
    if op == "reduce-scatter":
        return float((g - 1) * result_bytes)
    if op == "all-to-all":
        return (g - 1) / g * result_bytes
    return float(result_bytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _in_propagation() -> bool:
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


# GPUs a node joins by NVLink (an H100 SXM node); a group with ranks on
# more than one node crosses the inter-node network
NODE_GPUS = 8


def _group(args) -> tuple[int, bool]:
    """A functional collective's (group size, whether its ranks span more
    than one node of :data:`NODE_GPUS` consecutive ranks)."""
    import torch.distributed as dist

    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    if name is None:
        ranks = list(range(dist.get_world_size()))
    else:
        pg = dist.distributed_c10d._resolve_process_group(name)
        ranks = dist.get_process_group_ranks(pg)
    return len(ranks), len({r // NODE_GPUS for r in ranks}) > 1


@dataclasses.dataclass
class Counts:
    """One step's totals on one rank (see the module docstring)."""

    flops: float
    traffic_bytes: float
    bytes_by_op: dict
    count_by_op: dict
    wire_bytes_by_op: dict
    wire_bytes_by_link: dict   # "nvlink" / "network" -> wire bytes
    peak_bytes: int
    ops: dict       # aten op -> [count, flops, traffic bytes]
    hot: dict       # (op, result shape) -> traffic bytes
    # the largest storages live at the peak: (bytes, op, shape, dtype)
    peak_live: list = dataclasses.field(default_factory=list)

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes_by_op.values()))

    def table(self, top: int = 40) -> dict:
        """The op table a dry-run cell writes in place of HLO text: every
        aten op with its count, FLOPs and bytes, the ``top`` result shapes
        by traffic, and the collectives."""
        hot = sorted(self.hot.items(), key=lambda kv: -kv[1])[:top]
        return {
            "ops": {k: {"count": v[0], "flops": v[1], "bytes": v[2]}
                    for k, v in sorted(self.ops.items(),
                                       key=lambda kv: -kv[1][2])},
            "hot": [{"op": k[0], "shape": k[1], "bytes": v}
                    for k, v in hot],
            "collectives": {op: {"count": self.count_by_op[op],
                                 "bytes": self.bytes_by_op[op],
                                 "wire_bytes": self.wire_bytes_by_op[op]}
                            for op in sorted(self.count_by_op)},
        }


class Recorder(TorchDispatchMode):
    """Counts the aten ops run under it (``with Recorder() as rec: ...``;
    then ``rec.counts()``). Live bytes start at 0: the step's arguments
    are the caller's to add. The storages live at the peak are taken
    whenever the peak passes the last taking by :data:`PEAK_STEP`, so
    they are those of a moment within that share of the peak."""

    PEAK_TOP = 8
    PEAK_STEP = 0.005

    def __init__(self):
        super().__init__()
        self._ops = defaultdict(lambda: [0, 0.0, 0.0])
        self._hot = defaultdict(float)
        self._coll = defaultdict(lambda: [0, 0.0, 0.0])
        self._links = {"nvlink": 0.0, "network": 0.0}
        self._live: dict = {}
        self._seen: set = set()
        self._outside: set = set()
        self.live = 0
        self.peak = 0
        self._taken = 0
        self.peak_live: list = []

    def exclude(self, tensors) -> None:
        """Leave the storages of ``tensors`` (the step's arguments, whose
        bytes the caller counts; a DTensor's local shard) out of the live
        bytes, also where an op writes into them in place."""
        for t in tensors:
            if _is_dtensor(t):
                t = t.to_local()
            self._outside.add(t.untyped_storage()._cdata)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor(a) for a in _tensors((args, kwargs))):
            # DTensor's own dispatch runs the rank's ops, which come back
            # here on local tensors
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        pkt = func._overloadpacket
        name = pkt.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "c10d",
                  "_dtensor"):
            base = name.rstrip("_")
            if base in _COLLECTIVE:
                op = _COLLECTIVE[base]
                rb = sum(_nbytes(t) for t in _tensors(out))
                g, across = _group(args)
                wire = wire_factor(op, g, rb)
                c = self._coll[op]
                c[0] += 1
                c[1] += rb
                c[2] += wire
                self._links["network" if across else "nvlink"] += wire
            return
        flops = 0.0
        if pkt in flop_registry:
            flops = float(flop_registry[pkt](*args, **kwargs, out_val=out))
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        outs = _tensors(out)
        moved = 0.0
        if not view:
            moved = float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                          + sum(_nbytes(t) for t in outs))
        key = f"{ns}.{name}"
        rec = self._ops[key]
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        if moved:
            shape = tuple(outs[0].shape) if outs else ()
            self._hot[(key, str(shape))] += moved
        for t in outs:
            self._track(t, key)

    def _track(self, t: torch.Tensor, op: str) -> None:
        if id(t) in self._seen:
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._outside:
            return
        if key not in self._live:
            self._live[key] = [st.nbytes(), 0,
                               (op, tuple(t.shape), str(t.dtype))]
            self.live += st.nbytes()
            if self.live > self.peak:
                self.peak = self.live
                if self.peak > (1 + self.PEAK_STEP) * self._taken:
                    self._taken = self.peak
                    self.peak_live = [
                        (v[0],) + v[2] for v in heapq.nlargest(
                            self.PEAK_TOP, self._live.values(),
                            key=lambda v: v[0])]
        self._live[key][1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._free, key, id(t))

    def _free(self, key, ident) -> None:
        self._seen.discard(ident)
        e = self._live.get(key)
        if e is None:
            return
        e[1] -= 1
        if e[1] == 0:
            self.live -= e[0]
            del self._live[key]

    def counts(self) -> Counts:
        ops = {k: list(v) for k, v in self._ops.items()}
        return Counts(
            flops=sum(v[1] for v in ops.values()),
            traffic_bytes=sum(v[2] for v in ops.values()),
            bytes_by_op={k: v[1] for k, v in self._coll.items()},
            count_by_op={k: v[0] for k, v in self._coll.items()},
            wire_bytes_by_op={k: v[2] for k, v in self._coll.items()},
            wire_bytes_by_link=dict(self._links), peak_bytes=self.peak,
            ops=ops, hot=dict(self._hot), peak_live=list(self.peak_live))
