"""Block-based cross-validation (paper §3.6.1).

The dataset is split into equally-sized *blocks* (iris: 5 blocks of 30, the
highest common factor of the 30/60/60 set sizes). Blocks are permuted into
*orderings*; for each ordering the first blocks form the offline-training set,
the next the validation set, and the last the online-training set. Experiments
re-run across orderings and average — this module materialises all ordering
datasets as stacked arrays so the whole sweep runs over one leading ordering
axis (the paper's block-ROM + ordering-manipulation subsystem).
"""
# A copy of the reference package's numpy-only module of the same name:
# the port keeps its own, so both packages see the same orderings by value.
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Set sizes in *blocks*: iris paper = 1 offline / 2 validation / 2 online."""

    block_len: int = 30
    offline_blocks: int = 1
    validation_blocks: int = 2
    online_blocks: int = 2

    @property
    def n_blocks(self) -> int:
        return self.offline_blocks + self.validation_blocks + self.online_blocks

    def sizes(self) -> tuple[int, int, int]:
        return (
            self.offline_blocks * self.block_len,
            self.validation_blocks * self.block_len,
            self.online_blocks * self.block_len,
        )


class OrderedSets(NamedTuple):
    """Stacked per-ordering sets; leading axis = ordering."""

    offline_x: np.ndarray    # [O, n_off, f] bool
    offline_y: np.ndarray    # [O, n_off] i32
    validation_x: np.ndarray
    validation_y: np.ndarray
    online_x: np.ndarray
    online_y: np.ndarray


def all_orderings(n_blocks: int) -> np.ndarray:
    """All block permutations in lexicographic order. [n_blocks!, n_blocks]."""
    return np.array(list(itertools.permutations(range(n_blocks))), dtype=np.int64)


def select_orderings(n_blocks: int, n_orderings: int, seed: int = 0) -> np.ndarray:
    """First ``n_orderings`` of a seeded shuffle of all permutations.

    The paper uses all 120 iris orderings; smaller counts subsample evenly for
    cheap CPU runs while staying deterministic.
    """
    full = all_orderings(n_blocks)
    total = len(full)
    if n_orderings >= total:
        return full
    rng = np.random.default_rng(seed)
    idx = rng.permutation(total)[:n_orderings]
    return full[np.sort(idx)]


def make_sets(
    xs: np.ndarray,
    ys: np.ndarray,
    spec: BlockSpec,
    orderings: np.ndarray,
) -> OrderedSets:
    """Assemble (offline/validation/online) sets for every ordering."""
    n, f = xs.shape
    if n != spec.n_blocks * spec.block_len:
        raise ValueError(
            f"dataset length {n} != n_blocks*block_len "
            f"{spec.n_blocks}*{spec.block_len}"
        )
    blocks_x = xs.reshape(spec.n_blocks, spec.block_len, f)
    blocks_y = ys.reshape(spec.n_blocks, spec.block_len)

    def gather(block_ids: np.ndarray):  # [O, k] -> ([O, k*L, f], [O, k*L])
        bx = blocks_x[block_ids]  # [O, k, L, f]
        by = blocks_y[block_ids]
        O, k, L = by.shape
        return bx.reshape(O, k * L, f), by.reshape(O, k * L)

    a = spec.offline_blocks
    b = a + spec.validation_blocks
    off_x, off_y = gather(orderings[:, :a])
    val_x, val_y = gather(orderings[:, a:b])
    onl_x, onl_y = gather(orderings[:, b:])
    return OrderedSets(off_x, off_y, val_x, val_y, onl_x, onl_y)


def paper_sets(
    xs: np.ndarray,
    ys: np.ndarray,
    n_orderings: int,
    seed: int = 2023,
    spec: BlockSpec | None = None,
) -> tuple[OrderedSets, BlockSpec]:
    """The paper's block-CV recipe over an arbitrary booleanized dataset.

    Default spec is the 1/2/2 split at ``block_len = n_rows // 5`` — the
    iris geometry (30/60/60 at 150 rows) generalized so any dataset with
    ``5 | n_rows`` rides the same cross-validation flows regardless of
    feature width.
    """
    if spec is None:
        n = xs.shape[0]
        if n % 5:
            raise ValueError(f"default 5-block spec needs 5 | n_rows, got {n}")
        spec = BlockSpec(block_len=n // 5, offline_blocks=1,
                         validation_blocks=2, online_blocks=2)
    orderings = select_orderings(spec.n_blocks, n_orderings, seed=seed)
    return make_sets(xs, ys, spec, orderings), spec


def iris_paper_sets(
    n_orderings: int = 120, seed: int = 2023
) -> tuple[OrderedSets, BlockSpec]:
    """The paper's exact iris split: 5 blocks of 30 -> sets of 30/60/60."""
    from repro_torch.data import iris

    xs, ys = iris.load(seed=seed)
    return paper_sets(xs, ys, n_orderings, seed=seed)


def mnist_paper_sets(
    n_orderings: int = 120, seed: int = 2023, side: int | None = None
) -> tuple[OrderedSets, BlockSpec]:
    """The same 5-block CV recipe on the MNIST-scale digit workload.

    150 generated rows (10 balanced classes) -> sets of 30/60/60 at
    ``f = side**2`` boolean inputs — the wide-datapath twin of
    :func:`iris_paper_sets`, so every sweep/system/serving flow accepts
    it with zero host-side reshaping. ``side`` defaults to the full
    28x28 raster; pass 14 or 7 for CPU-cheap runs.
    """
    from repro_torch.data import mnist

    xs, ys = mnist.load(seed=seed, side=mnist.SIDE if side is None else side)
    return paper_sets(xs, ys, n_orderings, seed=seed)
