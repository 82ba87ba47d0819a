"""MNIST-scale machine: Tsetlin Machine on the booleanized digit workload.

784 boolean inputs (28x28 per-pixel threshold), 10 classes. The paper's
clause-budget guidance (§3.1/§5: provision clauses per class roughly with
problem difficulty, over-provision rather than re-synthesize) scaled from
the iris calibration: iris uses 16 clauses for a 3-class/16-input problem;
the digit workload carries 10 classes at 49x the input width, so the
preset provisions 64 clauses per class — the same order MATADOR-class TM
hardware flows use for booleanized-MNIST — with 6-bit-plus TAs
(``n_states=63``: the widest that keeps the TA bank int8, the paper's
few-bits-per-TA bias at 1568 literals x 640 clause rows = a ~1 MB bank).

``T`` scales with the clause budget (T ~= clauses/2, as the iris preset's
15 ~= 16); ``s`` is calibrated on the generated workload (s=2.0/T=32
reaches ~0.97 train / ~0.82 held-out accuracy in 10 offline epochs at
14x14 on 100 rows; higher s under-includes at this width — the sweep in
tests/test_scale.py keeps the calibration honest).

``config_for_side`` is the downscale knob's twin: the same machine at
14x14 (f=196) or 7x7 (f=49) for tests and benchmarks that must stay
CPU-cheap while exercising the identical code paths.
"""
import dataclasses

from repro_torch.configs.tm_iris import TMSystemParams
from repro_torch.core.tm import TMConfig
from repro_torch.data import mnist as mnist_data

SIDE = mnist_data.SIDE  # 28


def config_for_side(side: int = SIDE) -> TMSystemParams:
    """The MNIST-scale system preset at raster width ``side``.

    ``n_features = side**2``; everything else (clause budget, s/T, cycle
    counts) is width-independent so a 14x14 run exercises exactly the
    full-width program shapes modulo the literal axis.
    """
    return TMSystemParams(
        tm=TMConfig(
            n_features=side * side,
            max_classes=mnist_data.N_CLASSES,
            max_clauses=64,
            n_states=63,   # widest int8 TA bank (2N = 126 <= 127)
            s_policy="standard",
            boost_true_positive=True,
        ),
        s_offline=2.0,
        s_online=1.5,
        T=32,
        n_offline_epochs=10,
        n_online_cycles=16,
        n_orderings=120,
        offline_limit=20,
    )


CONFIG = config_for_side(SIDE)

# Over-provisioned variant (§3.1.1): clause headroom held in reserve,
# enabled at runtime without re-JIT (the paper's re-synthesis avoidance).
OVERPROVISIONED = dataclasses.replace(
    CONFIG,
    tm=dataclasses.replace(CONFIG.tm, max_clauses=128),
)


def smoke_config(side: int = 14) -> TMSystemParams:
    """CI-sized variant: downscaled raster, short offline/online schedule."""
    return dataclasses.replace(
        config_for_side(side),
        n_offline_epochs=2, n_online_cycles=2, n_orderings=2,
    )
