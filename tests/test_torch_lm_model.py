"""The port's LM stacks (``repro_torch.models.transformer``) against the
JAX package's on the CPU, for the five dense smoke configs, the two MoE
ones (olmoe-1b-7b, arctic-480b), the SSD one (mamba2-780m), the RG-LRU
hybrid (recurrentgemma-9b) and the vlm (llama-3.2-vision-11b).

Parameters come from the reference's ``params.materialize`` in this process
and cross through ``convert.lm_params_from_numpy``; the leaves that it
initialises to constants that would hide a fault (a CROSS layer's ``gate``
and ``ffn_gate``, zeros, make the layer an identity; the RG-LRU's
``conv_b``, ``b_a``, ``b_x`` and ``lambda_p``) are moved off them by
U(-1, 1) from a seed (``_draw_gates``). Inputs are seeded numpy arrays (a
vlm batch carries ``cross_embeds``). Tolerances:
* float32 logits and caches: max |port - ref| <= 1e-4 * max |ref|;
* bfloat16 (gemma3, olmoe, arctic, mamba2, recurrentgemma, llama-vision):
  max |port - ref| <= 3e-2 * max |ref|.
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
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import params as P
from repro_torch.models import moe, stubs, transformer

TOL = 1e-4
TOL_BF16 = 3e-2
DENSE = ["granite_8b", "gemma3_1b", "phi3_medium_14b", "qwen25_14b",
         "musicgen_medium"]
MOE_SSD = ["olmoe_1b_7b", "arctic_480b", "mamba2_780m"]
RGLRU_CROSS = ["recurrentgemma_9b", "llama32_vision_11b"]
ARCHS = DENSE + MOE_SSD + RGLRU_CROSS
MAX_SEQ = 24
# the leaves drawn off their constant inits: CROSS's gates, RG-LRU's
# biases and Lambda (the SSD's ``conv_b`` keeps its init)
GATES = ("gate", "ffn_gate")
RGLRU_CONSTS = ("conv_b", "b_a", "b_x", "lambda_p")


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


def _draw_gates(prm, seed: int = 7):
    """The reference's tree with the CROSS gates and the RG-LRU constants
    moved off their inits by U(-1, 1), drawn in sorted path order."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        keys = [k.key for k in path]
        if keys[-1] in GATES or ("rec" in keys and keys[-1] in RGLRU_CONSTS):
            return x + jnp.asarray(rng.uniform(-1.0, 1.0, x.shape),
                                   jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, prm)


def _per_layer(rc, prm):
    """Each stacked fan-in-scaled leaf rescaled to one layer's fan-in, as
    the remainder layers are drawn. At ``materialize``'s own init a stacked
    leaf's fan-in is the super-block count (1 here: std-1 weights), and
    there the RG-LRU state is ill-conditioned in float32: saturated gates
    drive a_t to within a few ulp of 1, where sqrt(1 - a_t^2) turns each
    last-bit difference upstream (XLA's and torch's exp, their fused
    multiply-adds) into a relative one of percents
    (``test_rglru_stacked_init_state_is_ill_conditioned``; ROADMAP queue
    3)."""
    specs = RT.model_specs(rc)

    def scale(path, x):
        s = specs
        for k in path:
            s = s[k.key]
        if s.init == "normal" and s.axes[0] == "layers":
            return x * (s.shape[0] / s.shape[1]) ** 0.5
        return x

    return jax.tree_util.tree_map_with_path(scale, prm)


def _setup(arch, stacked_init=False, **kw):
    """The smoke model, parameters from the reference's ``materialize``
    with ``_draw_gates``; the RG-LRU and vlm archs each layer at its own
    fan-in (``_per_layer``) unless ``stacked_init``."""
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), **kw)
    tc = dataclasses.replace(configs.get_smoke_config(arch), **kw)
    prm = RP.materialize(RT.model_specs(rc), jax.random.PRNGKey(0),
                         jnp.float32)
    if arch in RGLRU_CROSS and not stacked_init:
        prm = _per_layer(rc, prm)
    prm = _draw_gates(prm)
    tree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                        "cpu")
    return rc, tc, prm, transformer.Transformer(tc, tree, device="cpu")


_MODELS = {}


def model(arch, drop_free=False):
    """The smoke model; ``drop_free``: an MoE's capacity factor raised to
    its expert count, so no slot is dropped (the reference's own
    prefill -> decode check does this: at decode T = B tokens, and the
    capacity drops slots that a long forward keeps)."""
    key = (arch, drop_free)
    if key not in _MODELS:
        kw = {}
        moe = configs.get_smoke_config(arch).moe
        if drop_free and moe is not None:
            kw["moe"] = dataclasses.replace(
                moe, capacity_factor=float(moe.n_experts))
        _MODELS[key] = _setup(arch, **kw)
    return _MODELS[key]


def _forward_len(cfg, n: int) -> int:
    """The shortest length >= n that a forward accepts: an SSD stack needs
    S < chunk or a multiple of it (the model is causal, so positions
    below n read the same logits)."""
    if cfg.ssm is None or n < cfg.ssm.chunk:
        return n
    return -(-n // cfg.ssm.chunk) * cfg.ssm.chunk


def _inputs(cfg, B, S, seed):
    """(reference batch, port batch) over S positions: tokens, or stub
    embeddings for embeds_input; a vlm's also carry ``cross_embeds`` [B,
    n_cross_tokens, D]."""
    rng = np.random.default_rng(seed)
    if cfg.embeds_input:
        e = (0.05 * rng.standard_normal((B, S, cfg.d_model))).astype(
            np.float32)
        rb, tb = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    else:
        t = rng.integers(0, cfg.vocab_size, (B, S))
        rb, tb = ({"tokens": jnp.asarray(t, jnp.int32)},
                  {"tokens": torch.from_numpy(t)})
    if cfg.family == "vlm":
        c = (0.5 * rng.standard_normal((B, cfg.n_cross_tokens, cfg.d_model))
             ).astype(np.float32)
        rb["cross_embeds"], tb["cross_embeds"] = (jnp.asarray(c),
                                                  torch.from_numpy(c))
    return rb, tb


def _cut(batch, a, b):
    """Positions a..b of the sequence (``cross_embeds`` is not one)."""
    return {k: v if k == "cross_embeds" else v[:, a:b]
            for k, v in batch.items()}


def _step(batch, i):
    """The decode input for position i of a full batch."""
    key = "embeds" if "embeds" in batch else "token"
    src = batch.get("embeds", batch.get("tokens"))
    return {key: src[:, i:i + 1]}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    """The logits, and the MoE routers' aux loss summed over the layers
    (0 for the other stacks)."""
    rc, tc, prm, m = model(arch)
    rb, tb = _inputs(rc, 2, 13, seed=1)
    want, want_aux = RT.forward(rc, prm, rb)
    got, aux = m(tb)
    assert_close(got, want, what="logits")
    assert aux.dtype == torch.float32
    if rc.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert float(want_aux) > 0
        assert_close(aux, want_aux, what="aux")


@pytest.mark.parametrize("S", [5, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch, S):
    """Prompts shorter (5) and longer (12) than gemma3's 8-token window:
    the local caches hold the last W keys at their rotating slots."""
    rc, tc, prm, m = model(arch)
    rb, tb = _inputs(rc, 2, S, seed=2)
    want, wcache = RT.prefill(rc, prm, rb, MAX_SEQ)
    got, gcache = m.prefill(tb, MAX_SEQ)
    assert_close(got, want, what="prefill logits")
    assert_tree_close(convert.lm_cache_to_numpy(gcache), _np(wcache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache_match_reference(arch):
    """One step against the reference's synthetic decode cache (random
    K/V or SSD state, pos 7 of 32). The MoE archs run at their real
    capacity, one slot an expert at T = B = 2."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward_on_port(arch):
    """The reference's check (tests/test_models_smoke.py) on the port:
    decode(prefill(x[:S]), x[S]) == forward(x[:S+1])[S], here for 8
    steps past S = 12, so gemma3's and recurrentgemma's 8-slot windows
    wrap; held at TOL. The MoE archs run drop-free, as the reference's
    check does; mamba2's forward runs over 32 tokens (two 16-token
    chunks); the vlm's decode reads the image tokens' K/V from the
    cache."""
    rc, tc, prm, m = model(arch, drop_free=True)
    S, n = 12, 8
    _, tb = _inputs(rc, 2, _forward_len(rc, S + n), seed=3)
    full, _ = m(tb)
    _, cache = m.prefill(_cut(tb, 0, S), MAX_SEQ)
    for i in range(S, S + n):
        got, cache = m.decode_step({**_step(tb, i), "pos": i}, cache)
        assert_close(got, full[:, i].numpy(), what=f"position {i}")


def test_param_counts_match_analytic():
    """The port's spec tree at full size counts ModelConfig.param_count()
    plus what that count leaves out, qkv biases (qwen) and layernorm
    biases (musicgen), an SSD layer's conv bias and skip D (mamba2), an
    RG-LRU layer's conv bias and block-diagonal gate weights
    (recurrentgemma) and a CROSS layer's two scalar gates (llama-vision),
    less the embedding table that an embeds_input model (musicgen) has
    no use for. It equals the reference's spec tree."""
    for arch in ARCHS:
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
        for kind in cfg.layer_kinds:
            if kind == "ssd":
                di = cfg.ssm.expand * cfg.d_model
                extra += di + 2 * cfg.ssm.d_state + di // cfg.ssm.head_dim
            elif kind == "rglru":
                di = cfg.ssm.expand * cfg.d_model
                extra += di + 2 * di * (di // cfg.n_heads)
            elif kind == "cross":
                extra += 2
        assert got == cfg.param_count() + extra, arch
        assert got == RP.count_params(RT.model_specs(
            rconfigs.get_config(arch))), arch
    assert configs.get_config("gemma3-1b").param_count() == 999_812_736
    assert configs.get_config("olmoe-1b-7b").param_count() == 6_919_096_320
    assert configs.get_config("mamba2-780m").param_count() == 779_986_944
    assert P.count_params(transformer.model_specs(configs.get_config(
        "recurrentgemma-9b"))) == 8_578_519_040
    assert P.count_params(transformer.model_specs(configs.get_config(
        "llama-3.2-vision-11b"))) == 9_775_157_264


@pytest.mark.parametrize("arch", ARCHS)
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
    assert jax.tree.map(lambda s: (s.shape, str(s.dtype)), rstruct) == {
        a: {b: {c: (s.shape, str(s.dtype).replace("torch.", ""))
                for c, s in leaf.items()}
            for b, leaf in sub.items()} for a, sub in tstruct.items()}


@pytest.mark.parametrize("arch", ARCHS)
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
    from repro.models import moe, transformer

    src, dst, arch = sys.argv[1], sys.argv[2], sys.argv[3]
    z = np.load(src)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="bfloat16")
    out = {}
    if cfg.moe is not None:
        # drop-free, and every router call's top-k and logits recorded
        # (an ordered callback: the scan's body is traced once)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        ffn = moe.moe_ffn

        def record(idx, logits):
            n = sum(k.startswith("route") for k in out)
            out[f"route{n}"] = np.asarray(idx)
            out[f"logits{n}"] = np.asarray(logits)

        def recorded(c, p, x, *, num_groups=1):
            cd = jnp.dtype(c.compute_dtype)
            xt = x.reshape(1, -1, x.shape[-1]).astype(cd)
            logits = jnp.einsum("gtd,de->gte", xt, p["router"].astype(cd)
                                ).astype(jnp.float32)
            _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                   c.moe.top_k)
            jax.debug.callback(record, idx[0], logits[0], ordered=True)
            return ffn(c, p, x, num_groups=num_groups)

        moe.moe_ffn = recorded
    prm = {}
    for name in z.files:
        if name.startswith("p/"):
            node, keys = prm, name[2:].split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = jnp.asarray(z[name])
    toks = jnp.asarray(z["tokens"], jnp.int32)
    S = int(z["S"])
    # a vlm batch: the image tokens' embeddings, in the compute dtype as
    # stubs.input_specs declares them (forward and prefill cast again)
    extra = ({"cross_embeds": jnp.asarray(z["cross_embeds"],
                                          jnp.dtype(cfg.compute_dtype))}
             if "cross_embeds" in z.files else {})
    out["forward"], _ = transformer.forward(cfg, prm,
                                            {"tokens": toks, **extra})
    out["prefill"], cache = transformer.prefill(
        cfg, prm, {"tokens": toks[:, :S], **extra}, int(z["max_seq"]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out["c/" + "/".join(k.key for k in path)] = leaf
    out["decode"], _ = transformer.decode_step(
        cfg, prm, {"token": toks[:, S:S + 1], "pos": jnp.int32(S)}, cache)
    jax.effects_barrier()
    np.savez(dst, **{k: np.asarray(v, np.int64 if k.startswith("route")
                                   else np.float32) for k, v in out.items()})
""")


def _route_flips(got: list, want, n_tokens: list) -> list:
    """Per call (forward, prefill, decode): the rows whose routing differs
    from the reference's in some MoE layer. Each difference must sit at a
    near-tie of the reference's router logits: every expert in one
    top-k set and not the other lies within TOL_BF16 * max |logits| of
    the reference's k-th logit. ``got`` holds the port's expert_idx
    [1, T, k] per router call, in the reference's call order."""
    assert len(got) == sum(k.startswith("route") for k in want.files)
    per_call = len(got) // len(n_tokens)
    rows = []
    for c, S in enumerate(n_tokens):
        flipped = set()
        for n in range(c * per_call, (c + 1) * per_call):
            g = np.sort(got[n][0].numpy(), axis=-1)
            w = np.sort(want[f"route{n}"], axis=-1)
            logits = want[f"logits{n}"]
            for t in np.nonzero((g != w).any(-1))[0]:
                kth = np.sort(logits[t])[::-1][g.shape[-1] - 1]
                odd = np.setxor1d(g[t], w[t])
                gap = np.max(np.abs(logits[t][odd] - kth))
                assert gap <= TOL_BF16 * np.max(np.abs(logits[t])), (
                    f"router call {n} token {t}: port {g[t]} vs reference "
                    f"{w[t]} at a logit gap of {gap}")
                flipped.add(int(t) // S)
        rows.append(sorted(flipped))
    return rows


def _bfloat16_case(arch, tmp_path):
    """``arch``'s smoke config at compute_dtype bfloat16: forward, prefill
    (logits and cache) of 12 tokens and one decode step, the reference
    run in a fresh process without excess precision; within TOL_BF16.
    The parameters (gates drawn off their inits, ``_draw_gates``) and the
    batch cross through a file: the tokens, and a vlm's ``cross_embeds``
    (float32 there, cast to bfloat16 on both sides as
    ``stubs.input_specs`` declares them).

    An MoE arch runs drop-free in both. Its router logits, which the
    attention feeds, differ between the packages by bf16 rounding, so at
    a near-tie a token's top-k set may differ; :func:`_route_flips`
    holds every such difference to the reference's logits, and the rows
    it touched (that call's, and the prefill's in the decode) are left
    out of the comparison and printed."""
    rc, tc, prm, _ = _setup(arch, compute_dtype="bfloat16")
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=float(tc.moe.n_experts)))
    m = transformer.Transformer(
        tc, convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                         "cpu"), device="cpu")
    S = 12
    _, tb = _inputs(rc, 2, S + 1, seed=5)
    flat = {"p/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(prm)[0]}
    if "cross_embeds" in tb:
        flat["cross_embeds"] = tb["cross_embeds"].numpy()
        tb["cross_embeds"] = tb["cross_embeds"].to(torch.bfloat16)
    np.savez(tmp_path / "in.npz", tokens=tb["tokens"].numpy(), S=S,
             max_seq=MAX_SEQ, **flat)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    r = subprocess.run([sys.executable, "-c", _BF16_REFERENCE,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz"),
                        arch],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    want = np.load(tmp_path / "out.npz")

    routes = []
    route = moe.route

    def recorded(*args):
        r = route(*args)
        routes.append(r.expert_idx)
        return r

    moe.route = recorded
    try:
        got, _ = m(tb)
        logits, cache = m.prefill(_cut(tb, 0, S), MAX_SEQ)
        # copies: decode writes the cache in place
        cache_np = jax.tree.map(np.array, convert.lm_cache_to_numpy(cache))
        step, _ = m.decode_step({**_step(tb, S), "pos": S}, cache)
    finally:
        moe.route = route
    skip = [[], [], []]
    if tc.moe is not None:
        skip = _route_flips(routes, want, [S + 1, S, 1])
        skip[2] = sorted(set(skip[1]) | set(skip[2]))
        print(f"{arch} bf16: rows left out for routing at a near-tie: "
              f"forward {skip[0]}, prefill {skip[1]}, decode {skip[2]}")
    assert min(map(len, skip)) < 2, skip

    def rows(x, call):
        keep = [b for b in range(2) if b not in skip[call]]
        return np.asarray(x.float() if torch.is_tensor(x) else x)[keep]

    assert_close(rows(got, 0), rows(want["forward"], 0), TOL_BF16,
                 "forward")
    assert_close(rows(logits, 1), rows(want["prefill"], 1), TOL_BF16,
                 "prefill")
    keep = [b for b in range(2) if b not in skip[1]]
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache_np)[0]:
        name = "c/" + "/".join(k.key for k in path)
        # rows on axis 1 of a stacked leaf [n_super, B, ...], else axis 0
        axis = 1 if path[0].key == "blocks" else 0
        assert_close(np.take(leaf, keep, axis),
                     np.take(want[name], keep, axis), TOL_BF16, name)
    assert_close(rows(step, 2), rows(want["decode"], 2), TOL_BF16, "decode")


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
    _bfloat16_case("gemma3_1b", tmp_path)


def _np_params(rc, seed: int, per_layer: bool) -> dict:
    """numpy parameters with the reference's initialisers in sorted path
    order (a stacked leaf's fan-in: one layer's if ``per_layer``, else
    ``materialize``'s super-block count), then ``_draw_gates``."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            RT.model_specs(rc), is_leaf=lambda s: isinstance(s, RP.PSpec))[0]:
        if s.init in ("zeros", "ones"):
            x = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        elif s.init == "normal":
            shape = (s.shape[1:] if per_layer and s.axes[0] == "layers"
                     else s.shape)
            fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
            x = s.scale / np.sqrt(fan_in) * rng.standard_normal(s.shape)
        else:
            x = s.scale * rng.standard_normal(s.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k.key, {})
        node[path[-1].key] = jnp.asarray(x, jnp.float32)
    return _draw_gates(out)


def test_rglru_stacked_init_state_is_ill_conditioned():
    """Why the RG-LRU parity tests draw each layer at its own fan-in
    (``_per_layer``): recurrentgemma smoke, six numpy seeds, the prefill
    state ``h`` of the second stacked RG-LRU layer in float32, each
    package's against the port's float64 evaluation. At ``materialize``'s
    stacked fan-in (std-1 weights) both packages miss it by more than 10x
    what they miss at each layer's own fan-in, where both stay within
    1e-6 of its range. Prints the ranges."""
    rc = rconfigs.get_smoke_config("recurrentgemma_9b")
    tc = configs.get_smoke_config("recurrentgemma_9b")
    t64 = dataclasses.replace(tc, compute_dtype="float64")
    rb, tb = _inputs(rc, 2, 12, seed=2)
    err: dict = {}
    for per_layer in (False, True):
        for seed in range(6):
            prm = _np_params(rc, seed, per_layer)
            host = jax.tree.map(np.asarray, prm)
            _, wc = RT.prefill(rc, prm, rb, MAX_SEQ)
            h = {}
            for c in (tc, t64):
                m = transformer.Transformer(
                    c, convert.lm_params_from_numpy(host, c, "cpu"),
                    device="cpu")
                h[c.compute_dtype] = m.prefill(tb, MAX_SEQ)[1][
                    "blocks"]["pos1"]["h"].numpy()
            truth = h["float64"]
            scale = np.max(np.abs(truth))
            for who, got in (("port", h["float32"]),
                             ("reference",
                              np.asarray(wc["blocks"]["pos1"]["h"]))):
                err.setdefault((per_layer, who), []).append(
                    np.max(np.abs(got - truth)) / scale)
    for (per_layer, who), e in sorted(err.items()):
        print(f"{'per-layer' if per_layer else 'stacked'} init, {who}: h "
              f"against float64 {min(e):.2e} to {max(e):.2e} of its range")
    for who in ("port", "reference"):
        assert max(err[(True, who)]) <= 1e-6, who
        assert max(err[(False, who)]) > 10 * max(err[(True, who)]), who


@pytest.mark.parametrize("arch", RGLRU_CROSS)
def test_rglru_cross_bfloat16_matches_reference(arch, tmp_path):
    """The RG-LRU and vlm smoke configs at bfloat16, as the gemma3 case:
    recurrentgemma's gates, scan and state in float32 with their weights
    read unrounded (``compute_params`` keeps ``rglru.FLOAT_LEAVES``), its
    conv and gelu branch in bfloat16, its 8-slot LOCAL window wrapped by
    the 12-token prompt; llama-vision's CROSS layer over bfloat16
    ``cross_embeds``, its ``ck``/``cv`` cache in bfloat16."""
    _bfloat16_case(arch, tmp_path)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_780m"])
def test_moe_ssd_bfloat16_matches_reference(arch, tmp_path):
    """The MoE and SSD smoke configs at bfloat16, as the gemma3 case: the
    MoE routers drop-free in both packages (``capacity_factor =
    n_experts``, as ``_bfloat16_case`` and its reference script set it;
    dropped slots are held at float32 in ``tests/test_torch_lm_moe.py``),
    mamba2's SSD with its float32 leaves read unrounded
    (``compute_params``)."""
    _bfloat16_case(arch, tmp_path)


@pytest.mark.parametrize("arch", RGLRU_CROSS)
def test_unported_families_raise(arch):
    """The two families that raised ``NotImplementedError`` until their
    slice was ported (the RG-LRU hybrid and the vlm) now build: their
    configs' analytic counts agree, and ``materialize`` of ``model_specs``
    gives the reference's parameters leaf for leaf, in path, shape and
    dtype (the 0-d gates included, stacked to [n_super])."""
    cfg = configs.get_smoke_config(arch)
    rcfg = rconfigs.get_smoke_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    want = jax.tree_util.tree_flatten_with_path(RP.materialize(
        RT.model_specs(rcfg), jax.random.PRNGKey(0), jnp.float32))[0]
    got = P.materialize(transformer.model_specs(cfg),
                        torch.Generator().manual_seed(0), device="cpu")
    seen = 0
    for path, w in want:
        node = got
        for k in path:
            node = node[k.key]
        assert (tuple(node.shape), str(node.dtype)) == (
            w.shape, "torch." + str(w.dtype)), path
        seen += 1
    assert seen == len(T.leaves(got))
    gates = [p for p, _ in want if p[-1].key in GATES]
    assert len(gates) == (2 if cfg.family == "vlm" else 0)


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


@pytest.mark.parametrize("arch", MOE_SSD + RGLRU_CROSS)
def test_moe_ssd_trees_cross_both_ways(arch):
    """``convert`` carries the router and expert weights, the SSD and
    RG-LRU leaves (``w_a``, ``w_x`` of [n_super, nb, bw, bw]), a CROSS
    layer's 0-d ``gate`` and ``ffn_gate`` (stacked to [n_super]), the SSD
    and RG-LRU caches (float32 ``h``, the
    compute-dtype conv tail), the CROSS cache (``ck``/``cv``) and a train
    state (parameters and AdamW moments) of the reference's into the port
    and back, bit for bit."""
    from repro.train import train_step as RTS

    rc = dataclasses.replace(rconfigs.get_smoke_config(arch),
                             compute_dtype="bfloat16")
    tc = dataclasses.replace(configs.get_smoke_config(arch),
                             compute_dtype="bfloat16")
    rb = RS.synthetic_batch(rc, RShape("d", 16, 2, "decode"))
    cache = jax.tree.map(np.asarray, rb["cache"])
    got = convert.lm_cache_from_numpy(cache, "cpu")
    want_dtypes = transformer.cache_struct(tc, 2, 16)
    for top in got:
        for name in got[top]:
            for k, leaf in got[top][name].items():
                assert leaf.dtype == want_dtypes[top][name][k].dtype, k
    back = convert.lm_cache_to_numpy(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, leaf.astype(np.float32)), path

    prm = _draw_gates(RP.materialize(RT.model_specs(rc),
                                     jax.random.PRNGKey(1), jnp.float32))
    rstate = jax.tree.map(np.asarray, RTS.init_state(RTS.TrainConfig(), prm))
    state = convert.lm_train_state_from_numpy(rstate, tc, "cpu")
    leaf = state.params["blocks"]["pos0"]
    kind = rc.layer_pattern[0]
    assert set(leaf) >= {"ssd": {"mamba"}, "rglru": {"rec"}}.get(kind,
                                                                  {"ffn"})
    if rc.family == "vlm":
        gate = state.params["blocks"]["pos4"]["xattn"]["gate"]
        assert gate.shape == (1,) and float(gate[0]) != 0.0
    if kind == "rglru":
        assert leaf["rec"]["w_a"].shape == (1, 4, 16, 16)
    host = convert.lm_train_state_to_numpy(state)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(rstate)[0],
            jax.tree_util.tree_flatten_with_path(host)[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), pa
