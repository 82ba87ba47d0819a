"""The port's serving engine (``repro_torch.serve.engine``) against the JAX
package's ``Engine`` on the CPU, and ``random.categorical_logits`` against
``jax.random.categorical``.

Both engines get the same parameters (the reference's ``materialize``,
crossed through ``convert.lm_params_from_numpy``) and the same seeded
prompts. recurrentgemma's RG-LRU constants (``conv_b``, ``b_a``, ``b_x``,
``lambda_p``) are moved off their inits by U(-1, 1), and its stacked
layers drawn at their own fan-in (at the stacked init the RG-LRU state is
ill-conditioned in float32: tests/test_torch_lm_model.py). The vlm is not
served by ``generate`` in either package (tests/test_torch_lm_cross.py).
Tolerances:
* tokens, greedy and sampled: equal. Where a token differs, the reference's
  decision values at that step (its logits, or its gumbel noise plus
  logits / T) must have a top-2 gap within the float32 logit tolerance,
  1e-4 * max |ref logits|; the rest of that row is then not compared (it
  continues from another token). Otherwise the test fails;
* ``categorical_logits``: its uniform bits equal the reference's; its
  gumbel noise within 4 ulp of max(|g|, 1) (g = -log(y) is near 0 where
  y = -log(u) is near 1, so its error is absolute); samples as tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import params as RP
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro.serve.engine import EngineConfig as REngineConfig
from repro_torch import configs, convert
from repro_torch import random as R
from repro_torch.serve.engine import Engine, EngineConfig

TOL = 1e-4


def _rglru_draws(rc, prm, seed: int = 7):
    """Each stacked layer at its own fan-in, and the RG-LRU constants off
    their inits (U(-1, 1), sorted path order)."""
    specs = RT.model_specs(rc)
    rng = np.random.default_rng(seed)

    def draw(path, x):
        s = specs
        for k in path:
            s = s[k.key]
        if s.init == "normal" and s.axes[0] == "layers":
            x = x * (s.shape[0] / s.shape[1]) ** 0.5
        keys = [k.key for k in path]
        if "rec" in keys and keys[-1] in ("conv_b", "b_a", "b_x",
                                          "lambda_p"):
            x = x + jnp.asarray(rng.uniform(-1.0, 1.0, x.shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, prm)


def _setup(arch):
    rc = rconfigs.get_smoke_config(arch)
    tc = configs.get_smoke_config(arch)
    prm = RP.materialize(RT.model_specs(rc), jax.random.PRNGKey(0),
                         jnp.float32)
    if rc.family == "hybrid":
        prm = _rglru_draws(rc, prm)
    tree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                        "cpu")
    return rc, tc, prm, tree


def _prompts(cfg, B, S0, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)


def _ref_logits(rc, prm, prompts, want, step):
    """The reference's logits for every row at generation step ``step``:
    its forward over the prompt and its own first ``step`` tokens."""
    toks = jnp.asarray(np.concatenate([prompts, want[:, :step]], axis=1))
    logits, _ = RT.forward(rc, prm, {"tokens": toks})
    return np.asarray(logits[:, -1, :])


def assert_tokens_match(got, want, decision, logit_scale):
    """Equal, or each row's first difference at a reference near-tie."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        vals = decision(i)[b]
        top2 = np.sort(vals)[-2:]
        gap = top2[1] - top2[0]
        assert gap <= TOL * logit_scale(i), (
            f"row {b} step {i}: port {got[b, i]} vs reference {want[b, i]}, "
            f"reference top-2 gap {gap} above the tolerance "
            f"{TOL * logit_scale(i)}")


def _greedy_check(rc, prm, prompts, got, want):
    def decision(i):
        return _ref_logits(rc, prm, prompts, want, i)

    assert_tokens_match(got, want, decision,
                        lambda i: np.max(np.abs(decision(i))))


@pytest.mark.parametrize("arch,S0,new", [("granite_8b", 6, 7),
                                         ("gemma3_1b", 6, 10),
                                         ("olmoe_1b_7b", 6, 7),
                                         ("arctic_480b", 6, 7),
                                         ("mamba2_780m", 6, 10),
                                         ("recurrentgemma_9b", 2, 10)])
def test_greedy_generate_matches_reference_engine(arch, S0, new):
    """gemma3: 6 + 10 tokens wrap its 8-slot local windows. The MoE archs
    decode at their real capacity (one slot an expert at B = 2) in both
    engines; mamba2 decodes from the SSD state its prefill hands over,
    recurrentgemma from the RG-LRU state and a conv tail that holds the
    zero pad (a 2-token prompt), its MQA window wrapping at 8."""
    rc, tc, prm, tree = _setup(arch)
    B = 2
    prompts = _prompts(rc, B, S0)
    ec = dict(max_seq=S0 + new, batch_slots=B)
    want = REngine(rc, prm, REngineConfig(**ec)).generate(prompts, new)
    got = Engine(tc, tree, EngineConfig(**ec), device="cpu").generate(
        prompts, new)
    _greedy_check(rc, prm, prompts, got, want)


def test_engine_matches_manual_greedy_decode():
    """The port's twin of tests/test_serving.py's check: Engine.generate
    == a full forward re-run per emitted token, on the port."""
    _, tc, _, tree = _setup("granite_8b")
    B, S0, new = 2, 6, 5
    prompts = _prompts(tc, B, S0)
    eng = Engine(tc, tree, EngineConfig(max_seq=S0 + new, batch_slots=B),
                 device="cpu")
    got = eng.generate(prompts, new)

    toks = torch.from_numpy(prompts.astype(np.int64))
    want, steps = [], []
    for _ in range(new):
        logits, _ = eng.model({"tokens": toks})
        steps.append(logits[:, -1, :].numpy())
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        want.append(nxt.numpy().astype(np.int32))
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    want = np.stack(want, axis=1)
    assert_tokens_match(got, want, lambda i: steps[i],
                        lambda i: np.max(np.abs(steps[i])))


def _ref_keys(seed, n):
    """The reference engine's per-step sampling keys."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(k)
    return out


@pytest.mark.parametrize("arch,T,seed", [("granite_8b", 0.8, 3),
                                         ("gemma3_1b", 1.5, 11),
                                         ("olmoe_1b_7b", 1.0, 5),
                                         ("mamba2_780m", 1.2, 7),
                                         ("recurrentgemma_9b", 1.1, 9)])
def test_temperature_sampling_matches_reference_engine(arch, T, seed):
    rc, tc, prm, tree = _setup(arch)
    B, S0, new = 2, 5, 9
    prompts = _prompts(rc, B, S0, seed=1)
    ec = dict(max_seq=S0 + new, batch_slots=B, temperature=T)
    want = REngine(rc, prm, REngineConfig(**ec), seed=seed).generate(
        prompts, new)
    got = Engine(tc, tree, EngineConfig(**ec), seed=seed,
                 device="cpu").generate(prompts, new)
    keys = _ref_keys(seed, new)

    def decision(i):
        logits = _ref_logits(rc, prm, prompts, want, i)
        g = np.asarray(jax.random.gumbel(keys[i], logits.shape))
        return g + logits / np.float32(T)

    assert_tokens_match(
        got, want, decision,
        lambda i: np.max(np.abs(_ref_logits(rc, prm, prompts, want, i))) / T)
    # a seeded engine is deterministic, and another seed samples otherwise
    again = Engine(tc, tree, EngineConfig(**ec), seed=seed,
                   device="cpu").generate(prompts, new)
    assert np.array_equal(again, got)
    other = Engine(tc, tree, EngineConfig(**ec), seed=seed + 1,
                   device="cpu").generate(prompts, new)
    assert not np.array_equal(other, got)


def test_eos_trim_matches_reference_engine():
    """eos_id: the token the greedy run emits at step 2 of row 0, so row 0
    is trimmed after it; both engines trim alike."""
    rc, tc, prm, tree = _setup("granite_8b")
    B, S0, new = 2, 6, 8
    prompts = _prompts(rc, B, S0, seed=2)
    base = dict(max_seq=S0 + new, batch_slots=B)
    plain = Engine(tc, tree, EngineConfig(**base), device="cpu").generate(
        prompts, new)
    eos = int(plain[0, 2])
    want = REngine(rc, prm, REngineConfig(**base, eos_id=eos)).generate(
        prompts, new)
    got = Engine(tc, tree, EngineConfig(**base, eos_id=eos),
                 device="cpu").generate(prompts, new)
    assert np.array_equal(got, want)
    first = int(np.nonzero(plain[0] == eos)[0][0])
    assert (got[0, first:] == eos).all()
    assert np.array_equal(got[0, :first], plain[0, :first])


def test_generate_refuses_what_the_reference_asserts():
    _, tc, _, tree = _setup("granite_8b")
    eng = Engine(tc, tree, EngineConfig(max_seq=10, batch_slots=2),
                 device="cpu")
    with pytest.raises(ValueError, match="slots"):
        eng.generate(np.zeros((3, 4), np.int32), 2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(np.zeros((2, 8), np.int32), 3)


@pytest.mark.parametrize("seed", [0, 7, 2023])
def test_categorical_logits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((6, 1000))).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    tkey = convert.key_from_numpy(np.asarray(jax.random.key_data(key)),
                                  "cpu")
    tiny = float(np.finfo(np.float32).tiny)
    u_ref = np.asarray(jax.random.uniform(key, logits.shape, minval=tiny))
    u = R.uniform(tkey, logits.shape, minval=tiny).numpy()
    assert np.array_equal(u.view(np.int32), u_ref.view(np.int32))
    g_ref = np.asarray(jax.random.gumbel(key, logits.shape))
    g = R.gumbel(tkey, logits.shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(g_ref), 1.0).astype(np.float32))
    assert np.max(np.abs(g - g_ref) / ulp) <= 4
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = R.categorical_logits(tkey, torch.from_numpy(logits)).numpy()
    assert_tokens_match(got[:, None], want[:, None].astype(got.dtype),
                        lambda i: g_ref + logits,
                        lambda i: np.max(np.abs(logits)))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_launch_serve_moe_ssd_on_cpu(arch):
    """``python -m repro_torch.launch.serve --device cpu`` for the MoE,
    SSD and RG-LRU families: tokens in the vocabulary; a seeded run
    repeats."""
    from repro_torch.launch import serve

    cfg = configs.get_smoke_config(arch)
    base = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--max-new", "5"]
    out = serve.main(base)
    assert out.shape == (2, 5) and ((out >= 0) & (out < cfg.vocab_size)).all()
    assert np.array_equal(serve.main(base), out)
