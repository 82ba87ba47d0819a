"""MNIST-scale booleanized digit workload (procedural, dependency-free).

The paper's FPGA architecture targets edge workloads where the datapath
*width* dominates; booleanized MNIST (28x28 -> 784 boolean inputs, 10
classes) is the standard TM hardware benchmark at that width (MATADOR,
the runtime-tunable eFPGA TMs). Real MNIST cannot ship in-repo and may
not be downloaded in CI, so this module *generates* an MNIST-shaped
workload deterministically:

* each digit 0-9 is a glyph — a set of strokes (line segments) in the
  unit square, seven-segment geometry plus digit-specific diagonals so
  classes stay separable even at 7x7;
* each sample rasterizes its glyph onto an ``side x side`` grayscale
  grid under a per-sample random affine jitter (translate/scale/rotate),
  stroke-thickness jitter and additive pixel noise — every draw comes
  from ``SeedSequence([seed, index])``, so sample ``i`` is bitwise
  reproducible across processes and machines;
* per-pixel threshold booleanization (``pixel >= THRESHOLD``) yields
  ``f = side*side`` boolean inputs — f=784 at the paper-benchmark width,
  and the ``side`` knob scales the SAME workload down (14x14 -> f=196,
  7x7 -> f=49, 4x4 -> f=16 = iris width) for tests and benchmarks.

Labels depend only on ``(n, seed)`` — never on ``side`` — so a downscaled
run is the same classification problem at a narrower datapath.

The public API mirrors ``iris.py``: ``load`` returns
``(xs [n, f] bool, ys [n] i32)``; ``splits`` adds the seeded train/test
split the online-serving flows feed from.
"""
# A copy of the system's own digit generator (numpy only), so the
# benchmark makes its inputs without the system under test.
from __future__ import annotations

import numpy as np

SIDE = 28                       # the paper-benchmark raster width
N_CLASSES = 10
N_BOOL_FEATURES = SIDE * SIDE   # 784 boolean inputs at full width
THRESHOLD = 0.5                 # booleanization threshold (inclusive: >=)
N_POINTS = 150                  # default load() size — mirrors iris's 150
                                # rows so every block-CV flow (5 blocks of
                                # 30, sets 30/60/60) transfers unchanged

# Seven-segment stroke geometry in the unit square (x right, y down):
#   A top, B top-right, C bottom-right, D bottom, E bottom-left,
#   F top-left, G middle — plus digit-specific diagonals/flags so the
#   ten classes differ in stroke topology, not just segment subsets.
_X0, _X1 = 0.28, 0.72
_Y0, _Y1, _Y2 = 0.16, 0.50, 0.84
_SEG = {
    "A": ((_X0, _Y0), (_X1, _Y0)),
    "B": ((_X1, _Y0), (_X1, _Y1)),
    "C": ((_X1, _Y1), (_X1, _Y2)),
    "D": ((_X0, _Y2), (_X1, _Y2)),
    "E": ((_X0, _Y1), (_X0, _Y2)),
    "F": ((_X0, _Y0), (_X0, _Y1)),
    "G": ((_X0, _Y1), (_X1, _Y1)),
    # extras
    "slash": ((_X1, _Y0), (0.40, _Y2)),        # 7's descender
    "flag": ((0.38, 0.28), (0.50, _Y0)),       # 1's serif flag
    "zdiag": ((_X1, _Y0 + 0.04), (_X0, _Y2 - 0.04)),  # 2's diagonal
}
_GLYPHS: tuple[tuple[str, ...], ...] = (
    ("A", "B", "C", "D", "E", "F"),            # 0
    ("flag", "B", "C"),                        # 1
    ("A", "zdiag", "D"),                       # 2
    ("A", "B", "G", "C", "D"),                 # 3
    ("F", "G", "B", "C"),                      # 4
    ("A", "F", "G", "C", "D"),                 # 5
    ("A", "F", "E", "D", "C", "G"),            # 6
    ("A", "slash"),                            # 7
    ("A", "B", "C", "D", "E", "F", "G"),       # 8
    ("G", "F", "A", "B", "C", "D"),            # 9
)


def glyph_segments(digit: int) -> np.ndarray:
    """The digit's strokes as endpoint pairs. [n_seg, 2, 2] f32."""
    return np.asarray([_SEG[s] for s in _GLYPHS[digit]], dtype=np.float32)


def labels(n: int = N_POINTS, seed: int = 2023) -> np.ndarray:
    """Balanced shuffled labels [n] i32 — a function of (seed, index) ONLY.

    Block-shuffled: rows ``10k .. 10k+9`` are an independently seeded
    permutation of the ten classes, so every class appears ``n // 10`` or
    ``n // 10 + 1`` times (exactly balanced when ``10 | n``) AND the
    sequence is *prefix-stable* — label ``i`` never depends on ``n`` (or
    on ``side``), so growing a run extends it without perturbing earlier
    rows and every raster width sees the same labelled problem.
    """
    reps = -(-n // N_CLASSES)
    out = np.concatenate([
        np.random.default_rng(
            np.random.SeedSequence([seed, 0xBA15, k])
        ).permutation(N_CLASSES)
        for k in range(reps)
    ])
    return out[:n].astype(np.int32)


def _render(digit: int, side: int, rng: np.random.Generator) -> np.ndarray:
    """One jittered grayscale glyph raster [side, side] f32 in [0, 1]."""
    segs = glyph_segments(digit)                     # [S, 2, 2]

    # Per-sample affine jitter about the glyph center.
    scale = rng.uniform(0.85, 1.08)
    theta = rng.uniform(-0.12, 0.12)
    shift = rng.uniform(-0.05, 0.05, size=2)
    thick = rng.uniform(0.055, 0.095)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], dtype=np.float32)
    pts = (segs.reshape(-1, 2) - 0.5) * scale @ rot.T + 0.5 + shift
    segs = pts.reshape(-1, 2, 2)

    # Pixel centers in unit coordinates.
    c = (np.arange(side, dtype=np.float32) + 0.5) / side
    px = np.stack(np.meshgrid(c, c, indexing="xy"), axis=-1)  # [side, side, 2]

    # Distance from every pixel to every stroke (point-to-segment).
    a, b = segs[:, 0], segs[:, 1]                    # [S, 2]
    ab = b - a                                       # [S, 2]
    denom = np.maximum((ab * ab).sum(-1), 1e-12)     # [S]
    ap = px[None] - a[:, None, None]                 # [S, side, side, 2]
    t = np.clip((ap * ab[:, None, None]).sum(-1) / denom[:, None, None], 0, 1)
    proj = a[:, None, None] + t[..., None] * ab[:, None, None]
    d = np.sqrt(((px[None] - proj) ** 2).sum(-1)).min(axis=0)  # [side, side]

    # Antialiased ink + mild noise; soft edge spans ~ one full-width pixel
    # so downscaled rasters keep smooth strokes.
    soft = max(0.04, 1.0 / SIDE)
    img = np.clip((thick + soft - d) / soft, 0.0, 1.0)
    img = img + rng.uniform(0.0, 0.22, size=img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def raw(
    n: int = N_POINTS, seed: int = 2023, side: int = SIDE
) -> tuple[np.ndarray, np.ndarray]:
    """(images [n, side, side] f32 in [0,1], labels [n] i32).

    Sample ``i`` draws from ``SeedSequence([seed, 1 + i])`` — bitwise
    process-independent and O(1)-seekable (a slice of a bigger run equals
    generating those indices alone).
    """
    ys = labels(n, seed)
    imgs = np.empty((n, side, side), dtype=np.float32)
    for i in range(n):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 1 + i]))
        imgs[i] = _render(int(ys[i]), side, rng)
    return imgs, ys


def booleanize(imgs: np.ndarray, threshold: float = THRESHOLD) -> np.ndarray:
    """Per-pixel threshold booleanization -> [n, side*side] bool.

    Inclusive (``>=``): a pixel exactly at the threshold is ink — the
    same convention as iris's thermometer code.
    """
    n = imgs.shape[0]
    return (imgs >= threshold).reshape(n, -1)


def downscale(imgs: np.ndarray, factor: int = 2) -> np.ndarray:
    """Block-mean pooling [n, S, S] -> [n, S//factor, S//factor].

    The scale knob for tests/benchmarks: 28 -> 14 -> 7 halvings keep the
    glyph recognizable while shrinking the datapath width 4x per step.
    ``S`` must be divisible by ``factor``.
    """
    n, s, _ = imgs.shape
    if s % factor:
        raise ValueError(f"side {s} not divisible by downscale factor {factor}")
    k = s // factor
    return imgs.reshape(n, k, factor, k, factor).mean(axis=(2, 4))


def load(
    seed: int = 2023, n_points: int = N_POINTS, side: int = SIDE
) -> tuple[np.ndarray, np.ndarray]:
    """Booleanized digit workload: (xs [n, side*side] bool, ys [n] i32).

    Same API shape as the iris module's ``load``; ``side`` is the
    downscale knob (28 = the paper-benchmark f=784; 14/7 for tests).
    """
    imgs, ys = raw(n_points, seed, side)
    return booleanize(imgs), ys


def splits(
    n_train: int = 100,
    n_test: int = 50,
    seed: int = 2023,
    side: int = SIDE,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Seeded disjoint train/test splits of one generated run.

    (train_x, train_y, test_x, test_y) — the first ``n_train`` rows
    train, the next ``n_test`` test, from a single ``n_train + n_test``
    generation (so growing ``n_test`` never perturbs the train rows).
    """
    xs, ys = load(seed=seed, n_points=n_train + n_test, side=side)
    return xs[:n_train], ys[:n_train], xs[n_train:], ys[n_train:]
