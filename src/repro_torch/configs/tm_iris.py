"""The paper's own machine: Tsetlin Machine on iris (§5).

16 booleanised inputs, 3 classes, 16 clauses, T=15, s=1.375 offline / 1.0
online, 10 offline epochs, 16 online cycles, 120 block orderings. Classes and
clauses can be over-provisioned above the active counts (§3.1.1).
"""
import dataclasses

from repro_torch.core.tm import TMConfig


@dataclasses.dataclass(frozen=True)
class TMSystemParams:
    tm: TMConfig
    s_offline: float = 1.375
    s_online: float = 1.0
    T: int = 15
    n_offline_epochs: int = 10
    n_online_cycles: int = 16
    n_orderings: int = 120
    offline_limit: int = 20     # §5.1 uses 20 of the 30 offline rows


CONFIG = TMSystemParams(
    tm=TMConfig(
        n_features=16,
        max_classes=3,
        max_clauses=16,
        n_states=16,   # 5-bit TAs — calibrated against Fig 4 (EXPERIMENTS.md)
        s_policy="standard",
        boost_true_positive=True,
    ),
)

# Over-provisioned variant: a 4th class slot + 2x clauses held in reserve
# (enabled at runtime without re-JIT — the paper's re-synthesis avoidance).
OVERPROVISIONED = dataclasses.replace(
    CONFIG,
    tm=dataclasses.replace(CONFIG.tm, max_classes=4, max_clauses=32),
)


def smoke_config() -> TMSystemParams:
    return dataclasses.replace(
        CONFIG, n_offline_epochs=2, n_online_cycles=2, n_orderings=2
    )
