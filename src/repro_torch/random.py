"""Counter-based RNG: threefry2x32, bit for bit the reference's ``jax.random``.

The reference draws every random number through ``jax.random`` with the
threefry2x32 generator in its *partitionable* form: element ``i`` of any
draw is ``threefry2x32(key, (hi(i), lo(i)))`` of its flat index alone. This
module computes the same function on torch tensors, so a TA bank trained
here is bitwise the one the reference trains from the same seed.

A key is an int64 tensor of shape ``[2]`` holding two 32-bit words (the
reference's uint32 key data). All words live in int64 tensors masked to 32
bits, because CPU torch has no uint32 shifts; the rotations stay below
2**63, so no intermediate overflows (on CPU tensors the block function's
rounds run in numpy's uint32 and come back as int64). Every function
takes its key explicitly; there is no global generator.

Every function also takes a batch of keys ``[D, 2]`` (any leading shape)
and then equals ``jax.vmap`` of the single-key function: the key words
broadcast as ``[D, 1]`` against the counters, so one call costs the same
launches whatever D is.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block function on 32-bit words (int64).

    ``k0``/``k1`` are key words (scalar tensors), ``x0``/``x1`` the counter
    words (any shape). Returns the two output words. On CPU tensors the
    rounds run in numpy's uint32, which wraps by itself and costs a few
    times fewer host cycles an operation than torch's masked int64 ops;
    on the card they run as torch ops (:func:`_threefry_torch`).
    """
    if x0.device.type != "cpu":
        return _threefry_torch(k0, k1, x0, x1)
    k0, k1, x0, x1 = (t.numpy().astype(np.uint32) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    x0, x1 = np.broadcast_arrays(x0, x1)
    x0, x1 = x0.copy(), x1.copy()
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return (torch.from_numpy(x0.astype(np.int64)),
            torch.from_numpy(x1.astype(np.int64)))


def _threefry_torch(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` in torch ops on int64 words masked to 32 bits
    (the card's path)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: words (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two key words of ``key [..., 2]``, each ``[..., 1]`` so they
    broadcast against a trailing counter axis."""
    return key[..., 0:1], key[..., 1:2]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., num, 2]`` keys, row i =
    threefry(key, i)."""
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(*_words(key), hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data)) as a new key.

    ``data`` is an int, or a 1-D sequence of n ints: then the n keys
    ``[..., n, 2]`` (``jax.vmap`` over the data) come from one call."""
    if isinstance(data, (int, np.integer)):
        x = torch.tensor([0, int(data) & _M32], dtype=torch.int64,
                         device=key.device)
        b0, b1 = threefry2x32(*_words(key), x[:1], x[1:])
        return torch.cat([b0, b1], dim=-1)
    d = torch.as_tensor(np.asarray(data, dtype=np.int64) & _M32,
                        device=key.device)
    b0, b1 = threefry2x32(*_words(key), torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws (int64 tensor ``[..., *shape]``): the XOR of the two
    words."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(*_words(key), hi, lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as a mantissa in
    [1, 2), minus 1, scaled to [minval, maxval), floored at minval."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` in float32."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of a MASK of logits.

    With keys ``[R, 2]`` and logits ``[R, C]``, row r draws with key r.

    The reference samples ``argmax(gumbel + logits)`` with the low-mode
    gumbel ``-log(-log(uniform(minval=tiny)))``. Every logit here is 0
    (allowed) or -inf (masked), and the gumbel map is increasing, so the
    sample is the argmax of the uniform draw over the allowed classes. The
    first index wins ties, and an all-masked row gives 0, as in the
    reference. No ``log`` enters the result, so CPU and GPU agree with the
    reference bit for bit. Other logit values are outside this contract.
    """
    u = uniform(key, logits.shape[key.dim() - 1:])
    return torch.argmax(torch.where(logits == 0, u, -1.0), dim=-1)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, its default low mode:
    ``-log(-log(uniform(minval=tiny)))``. The uniform is bitwise the
    reference's; each ``log`` may differ from XLA's in the last bits."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny)))


def categorical_logits(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for any float32
    logits ``[..., V]`` and one key ``[2]``: the argmax of the gumbel noise
    over the whole logits shape plus the logits (first index on ties).

    Unlike :func:`categorical` (masks of 0/-inf only, and free of ``log``),
    this takes ``log`` twice, so a sample can differ from the reference's
    where two classes' noisy logits lie within a few ulp of each other."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
