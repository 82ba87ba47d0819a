"""The plain reference against the system's CPU path, at small sizes:
the random numbers, one learning step of a fleet (int8 and int16
banks), and prediction, all bit for bit."""
import numpy as np
import pytest
import torch

from reference import tm
from repro_torch import random as rnd
from repro_torch.core import feedback as fb
from repro_torch.core import tm as ptm

SEEDS = [0, 7, 2**31 + 5, 2**32 + 99]


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_the_system(seed):
    key = tm.key_from_seed(seed)
    assert torch.equal(key, rnd.PRNGKey(seed))
    assert torch.equal(tm.split(key, 5), rnd.split(key, 5))
    assert torch.equal(tm.fold_in(key, 3), rnd.fold_in(key, 3))
    assert torch.equal(tm.fold_in(key, np.arange(4)),
                       rnd.fold_in(key, np.arange(4)))
    keys = rnd.split(key, 3)
    assert torch.equal(tm.uniform(keys, (2, 5)), rnd.uniform(keys, (2, 5)))


def _machine(f, C, J, N):
    return tm.Machine(n_features=f, n_classes=C, n_clauses=J, n_states=N)


@pytest.mark.parametrize("f,C,J,N,s,T", [(16, 3, 16, 16, 1.0, 15),
                                         (49, 10, 8, 63, 1.5, 32),
                                         (49, 10, 20, 128, 10.0, 50)])
def test_fleet_step_matches_the_system(f, C, J, N, s, T):
    m = _machine(f, C, J, N)
    S = 6
    g = torch.Generator().manual_seed(3)
    dtype = torch.int8 if 2 * N <= 127 else torch.int16
    bank = torch.randint(N - 3, N + 4, (S,) + m.shape, generator=g,
                         dtype=dtype)
    x = torch.rand((S, f), generator=g) < 0.5
    y = torch.randint(0, C, (S,), generator=g)
    keys = rnd.split(rnd.PRNGKey(11), S)
    cfg = ptm.TMConfig(n_features=f, max_classes=C, max_clauses=J,
                       n_states=N)
    rt = ptm.init_runtime(cfg, s=s, T=T, device="cpu")
    want, _, _ = fb.train_update_replicated(cfg, ptm.TMState(bank), rt, x,
                                            y.to(torch.int32), keys)
    got = tm.feedback_update(
        m, bank.to(torch.int32), x, y, keys,
        torch.full((S,), s, dtype=torch.float32),
        torch.full((S,), T, dtype=torch.int32), torch.ones(S, dtype=bool))
    assert torch.equal(got, want.ta_state.to(torch.int32))
    # a step that is not valid leaves the bank alone
    kept = tm.feedback_update(
        m, bank.to(torch.int32), x, y, keys,
        torch.full((S,), s, dtype=torch.float32),
        torch.full((S,), T, dtype=torch.int32), torch.zeros(S, dtype=bool))
    assert torch.equal(kept, bank.to(torch.int32))


def test_prediction_matches_the_system():
    m = _machine(49, 10, 8, 63)
    g = torch.Generator().manual_seed(5)
    bank = torch.randint(40, 90, (4,) + m.shape, generator=g,
                         dtype=torch.int8)
    xs = torch.rand((37, 49), generator=g) < 0.5
    cfg = ptm.TMConfig(n_features=49, max_classes=10, max_clauses=8,
                       n_states=63)
    rt = ptm.init_runtime(cfg, device="cpu")
    want = ptm.predict_batch_replicated(cfg, ptm.TMState(bank), rt, xs[None])
    got = tm.predict(m, bank.to(torch.int32), xs, block=16)
    assert torch.equal(got, want.to(torch.int64))
