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
    rc, tc, prm, tree = _setup(per_layer=True)
    rb, tb = _batch(rc, 2, 12, seed=5)
    want = jax.grad(lambda p: RT.loss_fn(rc, p, rb)[0])(prm)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(), tree,
                      is_leaf=torch.is_tensor)
    transformer.loss_fn(tc, tp, tb)[0].backward()
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
