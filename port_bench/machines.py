"""A configuration file's machine, for the system and for the reference."""
from __future__ import annotations


def machine(config: dict):
    from reference import tm
    return tm.Machine(n_features=config["n_features"],
                      n_classes=config["n_classes"],
                      n_clauses=config["n_clauses"],
                      n_states=config["n_states"],
                      boost=config["boost_true_positive"],
                      s_policy=config["s_policy"])


def state_dtype(config: dict):
    import torch
    return torch.int8 if 2 * config["n_states"] <= 127 else torch.int16


def boundary_banks(config: dict, K: int, seed: int, device):
    """K banks at the decision boundary (N or N + 1 by a fair coin an
    automaton), drawn on the device from the seed in one call."""
    import torch
    m = machine(config)
    g = torch.Generator(device=device).manual_seed(int(seed))
    coin = torch.randint(0, 2, (K,) + m.shape, generator=g, device=device,
                         dtype=state_dtype(config))
    return coin + m.n_states


def tm_config(config: dict):
    from repro_torch.core.tm import TMConfig
    return TMConfig(n_features=config["n_features"],
                    max_classes=config["n_classes"],
                    max_clauses=config["n_clauses"],
                    n_states=config["n_states"],
                    s_policy=config["s_policy"],
                    boost_true_positive=config["boost_true_positive"])
