"""Evaluation engines: cross-validation x hyperparameter sweeps (paper
§3.6.1, §5)."""
from repro_torch.eval.crossval import (  # noqa: F401
    CrossValRun,
    SweepResult,
    SystemResult,
)
