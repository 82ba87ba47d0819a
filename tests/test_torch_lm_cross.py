"""The port's gated cross-attention (``layers.cross_attention``, the CROSS
layer of ``models/transformer.py``) against the JAX package's on the CPU,
at the llama-3.2-vision smoke width (d_model 64, 4 heads of 16, 2 kv heads,
9 stub image tokens).

At the reference's init a CROSS layer is the identity (``gate`` and
``ffn_gate`` are zeros, and tanh(0) = 0 multiplies both of its branches),
so a wrong cross-attention would pass every comparison made there: every
case here draws the two gates from the seed in [-1, 1]
(``_draw_gates``), except the one that checks that identity. Tolerance,
float32: max |port - ref| <= 1e-4 * max |ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro.serve.engine import EngineConfig as REngineConfig
from repro_torch import configs, convert
from repro_torch.models import layers, transformer
from repro_torch.serve.engine import Engine, EngineConfig

TOL = 1e-4
ARCH = "llama32_vision_11b"
MAX_SEQ = 24


def _cfgs(**kw):
    return (dataclasses.replace(rconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(configs.get_smoke_config(ARCH), **kw))


def _draw_gates(prm, seed: int):
    """The reference's parameter tree with every ``gate`` and ``ffn_gate``
    leaf moved off its zero init by U(-1, 1), in sorted path order."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if path[-1].key in ("gate", "ffn_gate"):
            return x + jnp.asarray(rng.uniform(-1.0, 1.0, x.shape),
                                   jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, prm)


def _per_layer(rc, prm):
    """Each stacked fan-in-scaled leaf rescaled to one layer's fan-in (at
    ``materialize``'s one-super-block count, std-1 weights make float32
    gradients ill-conditioned: tests/test_torch_lm_train.py)."""
    specs = RT.model_specs(rc)

    def scale(path, x):
        s = specs
        for k in path:
            s = s[k.key]
        if s.init == "normal" and s.axes[0] == "layers":
            return x * (s.shape[0] / s.shape[1]) ** 0.5
        return x

    return jax.tree_util.tree_map_with_path(scale, prm)


def _setup(gates=True, per_layer=False, **kw):
    rc, tc = _cfgs(**kw)
    prm = RP.materialize(RT.model_specs(rc), jax.random.PRNGKey(0),
                         jnp.float32)
    if per_layer:
        prm = _per_layer(rc, prm)
    if gates:
        prm = _draw_gates(prm, seed=1)
    tree = convert.lm_params_from_numpy(jax.tree.map(np.asarray, prm), tc,
                                        "cpu")
    return rc, tc, prm, tree


def _batch(rc, B, S, seed):
    """(reference batch, port batch): tokens and cross_embeds."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, rc.vocab_size, (B, S))
    ce = (0.5 * rng.standard_normal((B, rc.n_cross_tokens, rc.d_model))
          ).astype(np.float32)
    return ({"tokens": jnp.asarray(t, jnp.int32),
             "cross_embeds": jnp.asarray(ce)},
            {"tokens": torch.from_numpy(t),
             "cross_embeds": torch.from_numpy(ce)})


def assert_close(got, want, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches_reference(qkv_bias):
    """One gated cross-attention call, gate 0.7, queries from 6 text
    positions over 9 image tokens; with and without the q/k/v biases
    (drawn)."""
    rc, tc = _cfgs(qkv_bias=qkv_bias)
    rng = np.random.default_rng(2)
    p = {}
    for k, s in sorted(RL.attention_specs(rc, gated=True).items()):
        p[k] = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                if s.shape else np.array(0.7)).astype(np.float32)
    assert set(p) == set(layers.attention_specs(tc, gated=True))
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    ce = rng.standard_normal((2, 9, 64)).astype(np.float32)
    want = RL.cross_attention(rc, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jnp.asarray(ce))
    got = layers.cross_attention(tc, {k: torch.tensor(v)
                                      for k, v in p.items()},
                                 torch.tensor(x), torch.tensor(ce))
    assert_close(got, want, "cross_attention")
    assert float(np.max(np.abs(np.asarray(want)))) > 0.1


def _in_graph(t, name: str) -> bool:
    """Whether a node called ``name`` is in the autograd graph behind t."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        if fn.name() == name:
            return True
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return False


def _core_inputs(rc, S: int, seed: int):
    """q [2, S, 4, 16], k and v [2, N, 2, 16] and a cotangent like q."""
    rng = np.random.default_rng(seed)
    hq, hkv, dh, N = rc.n_heads, rc.n_kv_heads, rc.head_dim, \
        rc.n_cross_tokens
    return ((2.0 * rng.standard_normal((2, S, hq, dh))).astype(np.float32),
            (2.0 * rng.standard_normal((2, N, hkv, dh))).astype(np.float32),
            rng.standard_normal((2, N, hkv, dh)).astype(np.float32),
            rng.standard_normal((2, S, hq, dh)).astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 3e-2)])
def test_blocked_cross_matches_reference(dtype, tol):
    """The CROSS attention's query blocks (``layers._CrossBlocks``; attn_chunk
    4, S = 14: blocks of 4, 4, 4 and 2 rows, over N = 9 keys) against the
    reference's ``cross_attention`` core (``_gqa_scores_out`` with its zero
    mask): the output, and dq, dk, dv against ``jax.vjp``. float32 within
    TOL, bfloat16 within 3e-2 of max |ref|."""
    rc, tc = _cfgs(attn_chunk=4, compute_dtype=dtype)
    q, k, v, do = _core_inputs(rc, 14, seed=7)
    jd, td = jnp.dtype(dtype), layers._DTYPES[dtype]
    mask = jnp.zeros((1, 1, 14, rc.n_cross_tokens), jnp.float32)
    want, vjp = jax.vjp(lambda a, b, c: RL._gqa_scores_out(rc, a, b, c, mask),
                        *(jnp.asarray(x, jd) for x in (q, k, v)))
    wants = vjp(jnp.asarray(do, jd))
    xs = [torch.tensor(x, dtype=td).requires_grad_() for x in (q, k, v)]
    got = layers._CrossBlocks.apply(*xs, tc)
    gots = torch.autograd.grad(got, xs, torch.tensor(do, dtype=td))
    assert got.dtype == td and all(g.dtype == td for g in gots)
    assert_close(got.float(), np.asarray(want, np.float32), "out", tol)
    for name, g, w in zip(("dq", "dk", "dv"), gots, wants):
        assert_close(g.float(), np.asarray(w, np.float32), name, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_cross_against_the_dense_path(dtype):
    """``_CrossBlocks`` against the port's dense ``_gqa_scores_out`` on the
    same inputs (S = 14, blocks of 4). The forward is equal bit for bit
    on the CPU (the largest difference measured: 0; each block runs the
    dense path's ops on its rows), and so is dq; dk and dv sum the blocks
    in float32: measured 1.25e-07 / 1.29e-07 (float32) and 4.10e-03 /
    4.24e-03 (bfloat16) of max |dense|, held to TOL and 3e-2."""
    rc, tc = _cfgs(attn_chunk=4, compute_dtype=dtype)
    td = layers._DTYPES[dtype]
    q, k, v, do = (torch.tensor(x, dtype=td)
                   for x in _core_inputs(rc, 14, seed=8))
    mask = torch.zeros((1, 1, 14, rc.n_cross_tokens))
    outs = []
    for blocked in (True, False):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = (layers._CrossBlocks.apply(*xs, tc) if blocked else
             layers._gqa_scores_out(tc, *xs, mask))
        outs.append((o.detach(), *torch.autograd.grad(o, xs, do)))
    (o, dq, dk, dv), (o_d, dq_d, dk_d, dv_d) = outs
    assert torch.equal(o, o_d)
    assert torch.equal(dq, dq_d)
    tol = TOL if dtype == "float32" else 3e-2
    for name, g, w in (("dk", dk, dk_d), ("dv", dv, dv_d)):
        assert_close(g.float(), w.float().numpy(), name, tol)


@pytest.mark.parametrize("S,blocked", [(4, False), (14, True), (1, False)])
def test_cross_attention_takes_the_blocks_above_attn_chunk(S, blocked):
    """The gated layer (``cross_attention``) at attn_chunk 4 against the
    reference's: S = 14 runs the query blocks, S = 4 (= attn_chunk) and a
    decode step's S = 1 the dense path; output and the gradients of x,
    the image embeddings and every weight within TOL."""
    rc, tc = _cfgs(attn_chunk=4)
    rng = np.random.default_rng(9)
    p = {}
    for key, s in sorted(RL.attention_specs(rc, gated=True).items()):
        p[key] = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
                  if s.shape else np.array(0.7)).astype(np.float32)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    ce = rng.standard_normal((2, 9, 64)).astype(np.float32)
    dy = rng.standard_normal((2, S, 64)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda pp, a, b: RL.cross_attention(rc, pp, a, b),
        {key: jnp.asarray(val) for key, val in p.items()}, jnp.asarray(x),
        jnp.asarray(ce))
    wp, wx, wce = vjp(jnp.asarray(dy))
    tp = {key: torch.tensor(val).requires_grad_() for key, val in p.items()}
    tx, tce = (torch.tensor(a).requires_grad_() for a in (x, ce))
    got = layers.cross_attention(tc, tp, tx, tce)
    assert _in_graph(got, "_CrossBlocksBackward") == blocked
    assert_close(got, want, "cross_attention")
    got.backward(torch.tensor(dy))
    assert_close(tx.grad, wx, "dx")
    assert_close(tce.grad, wce, "d cross_embeds")
    for key in p:
        assert_close(tp[key].grad, wp[key], f"d {key}")


def test_cross_layer_is_the_identity_at_the_reference_init():
    """With the reference's own init (gates zero) a CROSS layer returns its
    input bit for bit, in both packages."""
    rc, tc, prm, tree = _setup(gates=False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ce = rng.standard_normal((2, 9, 64)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], prm["blocks"]["pos4"])
    want, _ = RT._apply_block(rc, "cross", rp, jnp.asarray(x),
                              jnp.asarray(ce), 1)
    assert np.array_equal(np.asarray(want), x)
    tp = {k: ({j: w[0] for j, w in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tree["blocks"]["pos4"].items()}
    got, aux = transformer._apply_block(tc, "cross", tp, torch.tensor(x),
                                        torch.tensor(ce))
    assert aux is None
    assert torch.equal(got, torch.tensor(x))


def test_forward_prefill_and_decode_match_reference():
    """The smoke stack (4 GLOBAL and 1 CROSS layer), gates drawn: forward
    logits; prefill logits and every cache leaf (the CROSS ``ck``/``cv``
    of the 9 image tokens: the reference's shape exactly, values within
    TOL); and two decode steps from that cache, which the CROSS layer
    reads and leaves as it was."""
    rc, tc, prm, tree = _setup()
    m = transformer.Transformer(tc, tree, device="cpu")
    rb, tb = _batch(rc, 2, 12, seed=4)
    want, _ = RT.forward(rc, prm, rb)
    got, _ = m(tb)
    assert_close(got, want, "forward")

    S = 10
    rp = {"tokens": rb["tokens"][:, :S], "cross_embeds": rb["cross_embeds"]}
    tp = {"tokens": tb["tokens"][:, :S], "cross_embeds": tb["cross_embeds"]}
    wl, wc = RT.prefill(rc, prm, rp, MAX_SEQ)
    gl, gc = m.prefill(tp, MAX_SEQ)
    assert_close(gl, wl, "prefill logits")
    for key in ("ck", "cv"):
        g = gc["blocks"]["pos4"][key]
        w = np.asarray(wc["blocks"]["pos4"][key])
        assert tuple(g.shape) == w.shape == (1, 2, 9, 2, 16)
        assert g.dtype == torch.float32
        assert_close(g, w, f"cache {key}")
    for i in ("0", "1", "2", "3"):
        for key in ("k", "v"):
            assert_close(gc["blocks"]["pos" + i][key],
                         wc["blocks"]["pos" + i][key], f"pos{i} {key}")
    cross_before = {k: gc["blocks"]["pos4"][k].clone() for k in ("ck", "cv")}
    for i in (S, S + 1):
        wd, wc = RT.decode_step(rc, prm, {"token": rb["tokens"][:, i:i + 1],
                                          "pos": jnp.int32(i)}, wc)
        gd, gc = m.decode_step({"token": tb["tokens"][:, i:i + 1],
                                "pos": i}, gc)
        assert_close(gd, wd, f"decode {i}")
    for k, v in cross_before.items():
        assert torch.equal(gc["blocks"]["pos4"][k], v)


def test_cross_gradients_match_reference():
    """d loss with respect to every leaf of the smoke stack, the gates
    among them (whose gradient the zero init would also hide: tanh'(0) is
    1, but the branches' weights get a zero gradient there), float32,
    within TOL of each leaf's range; each layer drawn with its own
    fan-in."""
    _check_loss_grads(*_setup(per_layer=True), S=12)


def test_blocked_cross_gradients_match_reference():
    """The same at attn_chunk 4 and S = 14: the CROSS layer's queries run
    in blocks of 4, the last one of 2 (the GLOBAL layers take the dense
    mask, 14 not being a multiple of 4)."""
    _check_loss_grads(*_setup(per_layer=True, attn_chunk=4), S=14,
                      blocked=True)


def _check_loss_grads(rc, tc, prm, tree, S, blocked=False):
    rb, tb = _batch(rc, 2, S, seed=5)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(rc, p, rb)[0]))(prm)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(), tree,
                      is_leaf=torch.is_tensor)
    loss = transformer.loss_fn(tc, tp, tb)[0]
    assert _in_graph(loss, "_CrossBlocksBackward") == blocked
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    loss.backward()
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = tp
        for k in path:
            node = node[k.key]
        name = "/".join(k.key for k in path)
        assert float(np.max(np.abs(np.asarray(w)))) > 0, name
        assert_close(node.grad, w, f"d {name}")


def test_missing_cross_embeds_raises():
    """Both packages' forward raise the same ValueError; the port's prefill
    too (the reference's fails there with an AttributeError)."""
    rc, tc, prm, tree = _setup()
    rb, tb = _batch(rc, 1, 4, seed=6)
    with pytest.raises(ValueError, match="CROSS layer requires cross_embeds"):
        RT.forward(rc, prm, {"tokens": rb["tokens"]})
    m = transformer.Transformer(tc, tree, device="cpu")
    with pytest.raises(ValueError, match="CROSS layer requires cross_embeds"):
        m({"tokens": tb["tokens"]})
    with pytest.raises(ValueError, match="CROSS layer requires cross_embeds"):
        m.prefill({"tokens": tb["tokens"]}, MAX_SEQ)
    bad = {"tokens": tb["tokens"], "cross_embeds": tb["cross_embeds"][:, :5]}
    with pytest.raises(ValueError, match="n_cross_tokens = 9"):
        m.prefill(bad, MAX_SEQ)


def test_engine_refuses_a_vlm():
    """``Engine.generate`` builds a prefill batch of tokens alone, which a
    CROSS layer cannot take: the reference's fails inside its prefill
    (``cross_kv.shape`` of None, ``layers.py:415``), the port's raises a
    ValueError that says how the vlm is served."""
    rc, tc, prm, tree = _setup()
    prompts = np.zeros((2, 4), np.int32)
    ec = dict(max_seq=8, batch_slots=2)
    with pytest.raises(AttributeError):
        REngine(rc, prm, REngineConfig(**ec)).generate(prompts, 2)
    eng = Engine(tc, tree, EngineConfig(**ec), device="cpu")
    with pytest.raises(ValueError, match="cross_embeds.*decode_step"):
        eng.generate(prompts, 2)


def test_launch_serve_refuses_a_vlm():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="stub embeddings"):
        serve.main(["--arch", "llama-3.2-vision-11b", "--device", "cpu"])
