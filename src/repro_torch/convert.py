"""Carry TA banks, runtimes, RNG keys and data sets between the two packages.

The reference package's ``TMState`` (one bank [C, J, L] or R replicas
[R, C, J, L]), ``TMRuntime`` (scalar or per-replica [R] s/T ports), uint32
key pairs ([2] or batches [D, 2]), ``manager.Sets``, packed np.uint32
words, ``online.SessionState`` (one machine or a [K, ...] fleet, with
bool or packed rings) and the LM's parameter trees, decode caches and
``TrainState``, taken as numpy arrays
(``jax.tree.map(np.asarray, x)``), become the port's on a given device;
:func:`to_numpy` and :func:`session_state_to_numpy` go back;
:func:`host_plane_to_reference` and :func:`host_plane_from_reference`
turn a host plane (numpy, as the service's residency store and
checkpoints hold it) between the two packages' dtypes. Packed words
are np.uint32 in the reference and int32 bit patterns in the port
(:mod:`repro_torch.kernels.packing`). Both packages then compute
the same thing from the same values. The port imports nothing of the
reference: these functions read fields by name.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.tm import TMRuntime, TMState, resolve_device
from repro_torch.kernels.packing import words_to_numpy  # noqa: F401


def state_from_numpy(state: Any, device=None) -> TMState:
    """A ``TMState`` whose ``ta_state`` is a numpy [(R,) C, J, L] int8/int16
    bank -> the port's ``TMState`` on ``device``."""
    dev = resolve_device(device)
    return TMState(ta_state=torch.from_numpy(
        np.array(state.ta_state)).to(dev))


def runtime_from_numpy(rt: Any, device=None) -> TMRuntime:
    """A ``TMRuntime`` of numpy arrays -> the port's, with the ports
    ``s``/``T`` (0-dim or [R]) as CPU tensors and the masks on
    ``device``."""
    dev = resolve_device(device)
    return TMRuntime(
        s=torch.from_numpy(np.array(rt.s, dtype=np.float32)),
        T=torch.from_numpy(np.array(rt.T, dtype=np.int32)),
        **{name: torch.from_numpy(np.array(getattr(rt, name), dtype=bool))
           .to(dev)
           for name in ("clause_mask", "class_mask", "ta_and_mask",
                        "ta_or_mask")},
    )


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A uint32 key pair [2], or a batch [..., 2] (the reference's raw key
    data) -> the port's int64 key tensor on ``device``."""
    dev = resolve_device(device)
    words = np.asarray(key, dtype=np.uint32).astype(np.int64)
    return torch.from_numpy(words).to(dev)


def to_numpy(x):
    """A tensor, or a NamedTuple of tensors (``TMState``, ``TMRuntime``,
    ``Sets``), -> numpy (a NamedTuple of the same type with numpy fields;
    None stays None). A key comes back as its two int64 words, each
    < 2**32."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return type(x)(*(to_numpy(f) for f in x))


def sets_from_numpy(sets: Any, device=None):
    """A reference ``manager.Sets`` of numpy arrays (any leading ordering
    axis) -> the port's ``Sets`` on ``device``: x and valid as bool, y as
    int32; a missing ``offline_train_valid`` stays None."""
    from repro_torch.core.manager import Sets

    dev = resolve_device(device)
    out = {}
    for name in Sets._fields:
        v = getattr(sets, name)
        if v is None:
            out[name] = None
            continue
        dtype = np.int32 if name.endswith("_y") else bool
        out[name] = torch.from_numpy(np.array(v, dtype=dtype)).to(dev)
    return Sets(**out)


def words_from_numpy(words, device=None) -> torch.Tensor:
    """Packed np.uint32 words -> the port's int32 words on ``device``
    (:func:`words_to_numpy` goes back)."""
    from repro_torch.kernels import packing

    return packing.words_from_numpy(words).to(resolve_device(device))


def session_state_from_numpy(ss: Any, device=None):
    """A reference ``SessionState`` of numpy arrays (one machine, or
    [K, ...] leaves) -> the port's on ``device``: the bank as it is, ring
    rows as bool or, when np.uint32, as the port's int32 words; labels,
    head, size and step as int32."""
    from repro_torch.core.online import SessionState
    from repro_torch.data.buffer import RingBuffer

    dev = resolve_device(device)
    x = np.asarray(ss.buf.data_x)
    data_x = (words_from_numpy(x, dev) if x.dtype == np.uint32
              else torch.from_numpy(x.astype(bool)).to(dev))

    def i32(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    return SessionState(
        tm=state_from_numpy(ss.tm, dev),
        buf=RingBuffer(data_x=data_x, data_y=i32(ss.buf.data_y),
                       head=i32(ss.buf.head), size=i32(ss.buf.size)),
        step=i32(ss.step))


def session_state_to_numpy(ss):
    """The port's ``SessionState`` -> numpy in the reference's types:
    packed ring rows come back as np.uint32."""
    from repro_torch.core.tm import is_packed

    out = to_numpy(ss)
    if is_packed(ss.buf.data_x):
        out = out._replace(buf=out.buf._replace(
            data_x=words_to_numpy(ss.buf.data_x)))
    return out


def host_plane_to_reference(ss, keys):
    """A host plane ``(SessionState, keys)`` of numpy in the port's dtypes
    (leaves leading with the replicas) -> the reference's: packed ring
    words as np.uint32 and keys as uint32 pairs (same bits)."""
    x = np.asarray(ss.buf.data_x)
    if x.dtype == np.int32:
        ss = ss._replace(buf=ss.buf._replace(data_x=x.view(np.uint32)))
    return ss, np.asarray(keys).astype(np.uint32)


def host_plane_from_reference(ss, keys):
    """The reference's host plane ``(SessionState, keys)`` (a checkpoint's
    numpy) -> the port's dtypes, still numpy: ring rows as bool or, when
    np.uint32, as int32 words; labels, head, size and step as int32; keys
    as int64 word pairs."""
    from repro_torch.core.online import SessionState
    from repro_torch.data.buffer import RingBuffer

    x = np.asarray(ss.buf.data_x)
    x = x.view(np.int32) if x.dtype == np.uint32 else x.astype(bool)

    def i32(a):
        return np.asarray(a, dtype=np.int32)

    return (SessionState(tm=TMState(np.asarray(ss.tm.ta_state)),
                         buf=RingBuffer(data_x=x, data_y=i32(ss.buf.data_y),
                                        head=i32(ss.buf.head),
                                        size=i32(ss.buf.size)),
                         step=i32(ss.step)),
            np.asarray(keys, dtype=np.uint32).astype(np.int64))


# ---------------------------------------------------------------------------
# The LM substrate: parameter and cache trees (nested dicts of arrays)
# ---------------------------------------------------------------------------


def _lm_tensor(a, dev) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``dev``; a bfloat16 array (the
    reference's, an ``ml_dtypes`` dtype numpy itself lacks) crosses by its
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The reference's LM parameter tree taken as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's parameter tree on
    ``device`` (what ``models.transformer.Transformer`` and
    ``serve.engine.Engine`` take), key for key, every key and shape checked
    against ``model_specs(cfg)``."""
    from repro_torch.models.params import PSpec
    from repro_torch.models.transformer import model_specs

    dev = resolve_device(device)

    def walk(spec: dict, node: dict, path: str) -> dict:
        if set(node) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)}, the "
                             f"model's {sorted(spec)}")
        out = {}
        for k, s in spec.items():
            if isinstance(s, PSpec):
                out[k] = _lm_tensor(node[k], dev)
                if tuple(out[k].shape) != s.shape:
                    raise ValueError(f"{path}{k}: shape "
                                     f"{tuple(out[k].shape)}, the model's "
                                     f"{s.shape}")
            else:
                out[k] = walk(s, node[k], f"{path}{k}.")
        return out

    return walk(model_specs(cfg), tree, "")


def lm_cache_from_numpy(cache: dict, device=None) -> dict:
    """The reference's decode cache as numpy (``blocks.pos{i}.k`` [n_super,
    B, T, Hkv, D], ``rem.rem{i}.v`` ...) -> the port's, key for key, on
    ``device``."""
    dev = resolve_device(device)
    return T.map(lambda a: _lm_tensor(a, dev), cache)


def _lm_numpy(t: torch.Tensor) -> np.ndarray:
    """One LM tensor -> numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's decode cache -> numpy, key for key; bfloat16 leaves come
    back as float32 (exact)."""
    return T.map(_lm_numpy, cache)


def lm_train_state_from_numpy(tree: Any, cfg, device=None):
    """The reference's ``TrainState`` taken as numpy arrays
    (``jax.tree.map(np.asarray, state)``: params, ``OptState(step, mu,
    nu)``, the compression residual or None) -> the port's
    ``train.train_step.TrainState`` on ``device``. The parameter and moment
    trees go through :func:`lm_params_from_numpy` (keys and shapes
    checked); the step stays a 0-d int32."""
    from repro_torch.distributed.collectives import CompressionState
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)
    opt = tree.opt
    comp = tree.compress
    return TrainState(
        params=lm_params_from_numpy(tree.params, cfg, dev),
        opt=OptState(
            step=torch.from_numpy(np.array(opt.step, dtype=np.int32)).to(dev),
            mu=lm_params_from_numpy(opt.mu, cfg, dev),
            nu=lm_params_from_numpy(opt.nu, cfg, dev)),
        compress=None if comp is None else CompressionState(
            residual=lm_params_from_numpy(comp.residual, cfg, dev)),
    )


def lm_train_state_to_numpy(state):
    """The port's ``TrainState`` -> the same NamedTuples of numpy arrays,
    key for key (bfloat16 leaves as float32, exact; the step a 0-d
    int32)."""
    return T.map(_lm_numpy, state)
