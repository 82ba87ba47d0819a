"""Bit-packed literal layout: 32-bit words for the boolean datapath.

The twin of the reference's ``kernels/packing.py``, with the same layout:

* **Word-major, LSB-first**: bit ``i`` of word ``w`` holds element
  ``32*w + i``. A vector of ``n`` bits packs into ``ceil(n/32)`` words and
  the unused high bits of the last word (the tail bits) are always zero;
  the packed clause kernels rely on it (``include & ~literals`` is
  tail-safe because the include tail is zero).
* **Literals pack as two feature halves**: ``[x, ~x]`` (length 2f) packs
  as ``[pack(x), pack(~x)]``, each half padded on its own, so the packed
  complement is a word operation (``~words & word_mask``). Include masks
  over the literal axis pack with the same split (:func:`pack_include`).

**Word type.** PyTorch on the CPU has no ``~``, ``>>`` or ``index_put``
for ``torch.uint32``, so the port carries every word as a ``torch.int32``
holding the uint32 bit pattern. A shift of a negative int32 is
arithmetic, so every shift here is masked. The numpy twins
(:func:`pack_bits_np`, :func:`unpack_bits_np`) work in ``np.uint32``,
the reference's type; :func:`words_from_numpy` and :func:`words_to_numpy`
are the only crossings between the two. The CUDA kernels read the same
bytes as ``uint32_t``.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
WORD_DTYPE = torch.int32    # the port's packed word: uint32 bits in an int32


def n_words(n_bits: int) -> int:
    """Words needed for a vector of ``n_bits`` bits."""
    return -(-n_bits // WORD_BITS)


def tail_bits(n_bits: int) -> int:
    """Valid bits in the last word (32 when ``n_bits`` is word-aligned)."""
    r = n_bits % WORD_BITS
    return WORD_BITS if r == 0 else r


def tail_mask(n_bits: int) -> int:
    """Python-int mask of the valid bits in the last word."""
    return (1 << tail_bits(n_bits)) - 1


def _as_int32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def word_mask(n_bits: int, device=None) -> torch.Tensor:
    """[n_words] int32: all ones per word (-1), tail bits masked off."""
    m = torch.full((n_words(n_bits),), -1, dtype=WORD_DTYPE, device=device)
    m[-1] = _as_int32(tail_mask(n_bits))
    return m


def words_from_numpy(words) -> torch.Tensor:
    """np.uint32 words -> the port's int32 words (same bits, a CPU copy)."""
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 words -> np.uint32 (same bits)."""
    return words.detach().cpu().numpy().view(np.uint32)


def as_words(x: torch.Tensor) -> torch.Tensor:
    """A ``torch.uint32`` tensor as the port's int32 words (a view); int32
    words pass through."""
    return x.view(WORD_DTYPE) if x.dtype == torch.uint32 else x


# ---------------------------------------------------------------------------
# Generic bit packing (torch and numpy twins)
# ---------------------------------------------------------------------------


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] bool -> [..., ceil(n/32)] int32 words, LSB-first, tail bits
    zero. One weighted sum per word, on the device of ``bits``."""
    bits = bits.to(torch.bool)
    n = bits.shape[-1]
    w = n_words(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    b = bits.reshape(bits.shape[:-1] + (w, WORD_BITS)).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    v = (b << shifts).sum(-1)                       # [0, 2**32), exact
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(WORD_DTYPE)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[..., ceil(n/32)] int32 words -> [..., n_bits] bool (the inverse of
    :func:`pack_bits`). ``(w >> i) & 1`` is bit i also for negative
    words: the arithmetic shift only fills bits above it."""
    words = as_words(words)
    shifts = torch.arange(WORD_BITS, dtype=WORD_DTYPE, device=words.device)
    b = (words[..., :, None] >> shifts) & 1
    b = b.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return b[..., :n_bits].to(torch.bool)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host-side :func:`pack_bits` in np.uint32 (the router's staging
    boundary and packed serving): little-endian ``np.packbits`` bytes read
    as little-endian words are exactly the LSB-first layout."""
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[-1]
    pad = n_words(n) * WORD_BITS - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), dtype=bool)], axis=-1)
    return np.packbits(bits, axis=-1, bitorder="little").view(
        "<u4").astype(np.uint32, copy=False)


def unpack_bits_np(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Host-side :func:`unpack_bits` on np.uint32 words."""
    words = np.ascontiguousarray(words, dtype="<u4")
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n_bits].astype(bool)


# ---------------------------------------------------------------------------
# The literal-axis layout: two feature halves
# ---------------------------------------------------------------------------


def lit_words(n_features: int) -> int:
    """Packed width of the literal vector [x, ~x]: 2 * ceil(f/32) words."""
    return 2 * n_words(n_features)


def pack_literals(x: torch.Tensor) -> torch.Tensor:
    """bool features [..., f] -> packed literals [..., 2*ceil(f/32)]:
    ``[pack_bits(x), pack_bits(~x)]``, not a contiguous pack of [2f]."""
    x = x.to(torch.bool)
    halves = pack_bits(torch.stack([x, ~x], dim=-2))      # [..., 2, nw]
    return halves.reshape(x.shape[:-1] + (-1,))


def literals_from_packed(x_packed: torch.Tensor,
                         n_features: int) -> torch.Tensor:
    """Packed features [..., ceil(f/32)] -> packed literals
    [..., 2*ceil(f/32)]. The complement half is ``~x & word_mask``, bit
    for bit ``pack_literals(unpack_bits(x_packed, f))``."""
    x_packed = as_words(x_packed)
    neg = ~x_packed & word_mask(n_features, x_packed.device)
    return torch.cat([x_packed, neg], dim=-1)


def pack_include(include: torch.Tensor, n_features: int) -> torch.Tensor:
    """Include masks [..., 2f] bool -> [..., 2*ceil(f/32)] words, with the
    two-half split of :func:`pack_literals` (one pack of the [..., 2, f]
    view, so one set of launches for both halves)."""
    include = include.to(torch.bool)
    halves = include.reshape(include.shape[:-1] + (2, n_features))
    return pack_bits(halves).reshape(include.shape[:-1] + (-1,))


def packed_row_bytes(n_features: int) -> int:
    """Bytes per packed feature row (the ingress and ring unit)."""
    return 4 * n_words(n_features)
