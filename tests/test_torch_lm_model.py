"""The port's dense LM stacks (``repro_torch.models.transformer``) against
the JAX package's on the CPU, for the five dense smoke configs.

Parameters come from the reference's ``params.materialize`` in this process
and cross through ``convert.lm_params_from_numpy``; inputs are seeded numpy
arrays. Tolerances:
* float32 logits and caches: max |port - ref| <= 1e-4 * max |ref|;
* bfloat16 (one gemma3 case): max |port - ref| <= 3e-2 * max |ref|.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import ShapeConfig as RShape
from repro.models import params as RP
from repro.models import stubs as RS
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import params as P
from repro_torch.models import stubs, transformer

TOL = 1e-4
TOL_BF16 = 3e-2
DENSE = ["granite_8b", "gemma3_1b", "phi3_medium_14b", "qwen25_14b",
         "musicgen_medium"]
UNPORTED = ["llama32_vision_11b", "recurrentgemma_9b", "arctic_480b",
            "olmoe_1b_7b", "mamba2_780m"]
MAX_SEQ = 24


def assert_close(got, want, tol=TOL, what=""):
    got = np.asarray(got.detach().cpu().to(torch.float32) if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want))
    assert err <= tol * scale, (f"{what}: max|d| {err} > {tol} * max|ref| "
                                f"{scale}")


def assert_tree_close(got: dict, want: dict, tol=TOL, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], tol, f"{path}{k}.")
        else:
            assert_close(got[k], want[k], tol, f"{path}{k}")


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _setup(arch, **kw):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), **kw)
    tc = dataclasses.replace(configs.get_smoke_config(arch), **kw)
    prm = RP.materialize(RT.model_specs(rc), jax.random.PRNGKey(0),
                         jnp.float32)
    tree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                        "cpu")
    return rc, tc, prm, transformer.Transformer(tc, tree, device="cpu")


_MODELS = {}


def model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = _setup(arch)
    return _MODELS[arch]


def _inputs(cfg, B, S, seed):
    """(reference batch, port batch) over S positions: tokens, or stub
    embeddings for embeds_input."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = (0.05 * rng.standard_normal((B, S, cfg.d_model))).astype(
            np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(0, cfg.vocab_size, (B, S))
    return ({"tokens": jnp.asarray(t, jnp.int32)},
            {"tokens": torch.from_numpy(t)})


def _cut(batch, a, b):
    return {k: v[:, a:b] for k, v in batch.items()}


def _step(batch, i):
    """The decode input for position i of a full batch."""
    key = "embeds" if "embeds" in batch else "token"
    src = batch.get("embeds", batch.get("tokens"))
    return {key: src[:, i:i + 1]}


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch):
    rc, tc, prm, m = model(arch)
    rb, tb = _inputs(rc, 2, 13, seed=1)
    want, _ = RT.forward(rc, prm, rb)
    got, aux = m(tb)
    assert_close(got, want, what="logits")
    assert float(aux) == 0.0


@pytest.mark.parametrize("S", [5, 12])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(arch, S):
    """Prompts shorter (5) and longer (12) than gemma3's 8-token window:
    the local caches hold the last W keys at their rotating slots."""
    rc, tc, prm, m = model(arch)
    rb, tb = _inputs(rc, 2, S, seed=2)
    want, wcache = RT.prefill(rc, prm, rb, MAX_SEQ)
    got, gcache = m.prefill(tb, MAX_SEQ)
    assert_close(got, want, what="prefill logits")
    assert_tree_close(convert.lm_cache_to_numpy(gcache), _np(wcache))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_and_cache_match_reference(arch):
    """One step against the reference's synthetic decode cache (random
    K/V, pos 7 of 32)."""
    rc, tc, prm, m = model(arch)
    rb = RS.synthetic_batch(rc, RShape("smoke_decode", 32, 2, "decode"))
    rcache = rb.pop("cache")
    tcache = convert.lm_cache_from_numpy(_np(rcache), "cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in rb.items()
          if k != "pos"}
    tb["pos"] = int(rb["pos"])
    want, wcache = RT.decode_step(rc, prm, rb, rcache)
    got, gcache = m.decode_step(tb, tcache)
    assert gcache is tcache
    assert_close(got, want, what="decode logits")
    assert_tree_close(convert.lm_cache_to_numpy(gcache), _np(wcache))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward_on_port(arch):
    """The reference's check (tests/test_models_smoke.py) on the port:
    decode(prefill(x[:S]), x[S]) == forward(x[:S+1])[S], here for 8
    steps past S = 12, so gemma3's 8-slot windows wrap; held at TOL."""
    rc, tc, prm, m = model(arch)
    S, n = 12, 8
    _, tb = _inputs(rc, 2, S + n, seed=3)
    full, _ = m(tb)
    _, cache = m.prefill(_cut(tb, 0, S), MAX_SEQ)
    for i in range(S, S + n):
        got, cache = m.decode_step({**_step(tb, i), "pos": i}, cache)
        assert_close(got, full[:, i].numpy(), what=f"position {i}")


def test_param_counts_match_analytic():
    """The port's spec tree at full size counts ModelConfig.param_count()
    plus what that count leaves out, qkv biases (qwen) and layernorm
    biases (musicgen), less the embedding table that an embeds_input
    model (musicgen) has no use for. It equals the reference's spec
    tree."""
    for arch in DENSE:
        cfg = configs.get_config(arch)
        got = P.count_params(transformer.model_specs(cfg))
        extra = 0
        if cfg.qkv_bias:
            extra += cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                * cfg.head_dim
        if cfg.norm == "layernorm":
            extra += (2 * cfg.n_layers + 1) * cfg.d_model
        if cfg.embeds_input:
            extra -= cfg.vocab_size * cfg.d_model
        assert got == cfg.param_count() + extra, arch
        assert got == RP.count_params(RT.model_specs(
            rconfigs.get_config(arch))), arch
    assert configs.get_config("gemma3-1b").param_count() == 999_812_736


@pytest.mark.parametrize("arch", DENSE)
def test_spec_and_cache_trees_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(
        RT.model_specs(rcfg), is_leaf=lambda s: isinstance(s, RP.PSpec))[0]
    got = transformer.model_specs(cfg)
    for path, spec in want:
        node = got
        for k in path:
            node = node[k.key]
        assert (node.shape, node.axes, node.init, node.scale) == (
            spec.shape, spec.axes, spec.init, spec.scale), path
    assert P.count_params(got) == RP.count_params(RT.model_specs(rcfg))
    rstruct = RT.cache_struct(rcfg, 4, 1088)
    tstruct = transformer.cache_struct(cfg, 4, 1088)
    assert jax.tree.map(lambda s: s.shape, rstruct) == {
        a: {b: {c: s.shape for c, s in leaf.items()}
            for b, leaf in sub.items()} for a, sub in tstruct.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_synthetic_batch_matches_reference(arch):
    """Same seed, same values (the reference draws in sorted-key order)."""
    cfg, rcfg = configs.get_smoke_config(arch), rconfigs.get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        want = RS.synthetic_batch(rcfg, RShape("s", 16, 2, kind), seed=4)
        got = stubs.synthetic_batch(cfg, ShapeConfig("s", 16, 2, kind),
                                    seed=4, device="cpu")
        if kind == "decode":
            assert got.pop("pos") == int(want.pop("pos"))
            got["cache"] = convert.lm_cache_to_numpy(got["cache"])
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        for path, w in flat_w:
            node = got
            for k in path:
                node = node[k.key]
            node = node.numpy() if torch.is_tensor(node) else node
            assert np.array_equal(np.asarray(node), np.asarray(w)), path


_BF16_REFERENCE = textwrap.dedent("""\
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.models import transformer

    src, dst = sys.argv[1], sys.argv[2]
    z = np.load(src)
    cfg = dataclasses.replace(configs.get_smoke_config("gemma3_1b"),
                              compute_dtype="bfloat16")
    prm = {}
    for name in z.files:
        if name.startswith("p/"):
            node, keys = prm, name[2:].split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = jnp.asarray(z[name])
    toks = jnp.asarray(z["tokens"], jnp.int32)
    S = int(z["S"])
    out = {}
    out["forward"], _ = transformer.forward(cfg, prm, {"tokens": toks})
    out["prefill"], cache = transformer.prefill(
        cfg, prm, {"tokens": toks[:, :S]}, int(z["max_seq"]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out["c/" + "/".join(k.key for k in path)] = leaf
    out["decode"], _ = transformer.decode_step(
        cfg, prm, {"token": toks[:, S:S + 1], "pos": jnp.int32(S)}, cache)
    np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in out.items()})
""")


def test_gemma3_bfloat16_matches_reference(tmp_path):
    """gemma3 smoke at compute_dtype bfloat16: forward, prefill (logits and
    cache; the prompt wraps the window) and one decode step, within
    TOL_BF16.

    XLA's CPU compiler may keep float32 where the program says bfloat16
    (``--xla_allow_excess_precision``, on by default), so the reference's
    bfloat16 numbers depend on how XLA fuses a call (its ``forward``
    scans the super-block as one compiled body, where the dots' float32
    results feed the softmax unrounded). The port rounds every op's result to
    bfloat16, as the program is written. So the reference runs here in a
    fresh process with that license off, held to its program's rounding;
    the parameters cross through a file."""
    rc, tc, prm, _ = _setup("gemma3_1b", compute_dtype="bfloat16")
    m = transformer.Transformer(
        tc, convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                         "cpu"), device="cpu")
    S = 12
    _, tb = _inputs(rc, 2, S + 1, seed=5)
    flat = {"p/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(prm)[0]}
    np.savez(tmp_path / "in.npz", tokens=tb["tokens"].numpy(), S=S,
             max_seq=MAX_SEQ, **flat)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    r = subprocess.run([sys.executable, "-c", _BF16_REFERENCE,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.load(tmp_path / "out.npz")

    got, _ = m(tb)
    assert_close(got, want["forward"], TOL_BF16, "forward")
    logits, cache = m.prefill(_cut(tb, 0, S), MAX_SEQ)
    assert_close(logits, want["prefill"], TOL_BF16, "prefill")
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            convert.lm_cache_to_numpy(cache))[0]:
        name = "c/" + "/".join(k.key for k in path)
        assert_close(leaf, want[name], TOL_BF16, name)
    step, _ = m.decode_step({**_step(tb, S), "pos": S}, cache)
    assert_close(step, want["decode"], TOL_BF16, "decode")


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_families_raise(arch):
    """Their configs load; building a model names the ROADMAP item."""
    cfg = configs.get_smoke_config(arch)
    assert cfg.param_count() == rconfigs.get_smoke_config(arch).param_count()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        transformer.model_specs(cfg)


def test_registry_matches_reference():
    assert configs.ARCH_IDS == rconfigs.ARCH_IDS
    assert configs.ALIASES == rconfigs.ALIASES
    for arch in configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            got = dataclasses.asdict(getattr(configs, get)(arch))
            want = dataclasses.asdict(getattr(rconfigs, get)(arch))
            assert got == want, (arch, get)
    assert configs.get_config("gemma3-1b") == configs.get_config("gemma3_1b")


def test_state_dict_keys_are_reference_paths():
    rc, tc, prm, m = model("gemma3_1b")
    want = {".".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(prm)[0]}
    assert set(m.state_dict()) == want
    assert m.state_dict()["blocks.pos5.attn.wq"].shape == (1, 64, 4, 16)


def test_params_from_numpy_checks_keys_and_shapes():
    tc = configs.get_smoke_config("granite_8b")
    spec = transformer.model_specs(tc)
    tree = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), spec,
        is_leaf=lambda s: isinstance(s, P.PSpec))
    convert.lm_params_from_numpy(tree, tc, "cpu")
    bad = dict(tree, head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="head: shape"):
        convert.lm_params_from_numpy(bad, tc, "cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_numpy({**tree, "extra": tree["head"]}, tc,
                                     "cpu")


def test_cache_crosses_both_ways_bitwise():
    rcfg = dataclasses.replace(rconfigs.get_smoke_config("gemma3_1b"),
                               compute_dtype="bfloat16")
    rb = RS.synthetic_batch(rcfg, RShape("d", 16, 2, "decode"))
    cache = jax.tree.map(np.asarray, rb["cache"])
    got = convert.lm_cache_from_numpy(cache, "cpu")
    assert got["blocks"]["pos5"]["k"].dtype == torch.bfloat16
    back = convert.lm_cache_to_numpy(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf.astype(np.float32)), path


def test_prompt_longer_than_a_global_cache_raises():
    rc, tc, prm, m = model("granite_8b")
    _, tb = _inputs(rc, 2, 9, seed=6)
    with pytest.raises(ValueError, match="9-token prompt"):
        m.prefill(tb, 8)
