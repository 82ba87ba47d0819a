"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the JAX
package's ``models/ssm.py`` (and ``transformer._ssd_final_state``) on the
CPU, at the mamba2 smoke width (d_model 64, 8 heads of 16, d_state 16,
chunk 16).

Parameters are drawn from a numpy seed, normal with each product's
fan-in, the decay and step bias at small values around the reference's
zeros; inputs are seeded numpy arrays. Tolerances, float32:
max |port - ref| <= 1e-4 * max |ref| for outputs, states and each
gradient leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import params as RP
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.models import ssm, transformer

TOL = 1e-4
ARCH = "mamba2_780m"


def _cfgs(**kw):
    return (dataclasses.replace(rconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(configs.get_smoke_config(ARCH), **kw))


def _params(rc, seed: int, dt_bias: float = 0.0) -> dict:
    """One SSD layer's parameters (numpy float32) in sorted path order:
    products normal with their fan-in, ``conv_w`` at the reference's
    0.1 scale, the 1-D leaves near their initial values (so every term of
    the block, bias and skip included, is exercised)."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(
        RS.ssd_specs(rc), is_leaf=lambda s: isinstance(s, RP.PSpec))[0]
    out = {}
    for path, s in flat:
        name = path[-1].key
        if s.init == "normal":
            x = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif s.init == "scaled":
            x = s.scale * rng.standard_normal(s.shape)
        else:
            base = {"ones": 1.0, "zeros": 0.0}[s.init]
            x = base + 0.1 * rng.standard_normal(s.shape)
        if name == "dt_bias":
            x = x + dt_bias
        out[name] = x.astype(np.float32)
    return out


def _x(rc, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, rc.d_model)).astype(np.float32)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def assert_close(got, want, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("S", [8, 16, 64])
def test_ssd_forward_matches_reference(S):
    """S = chunk/2 (one short chunk), chunk, 4 chunks (the inter-chunk
    triangular product)."""
    rc, tc = _cfgs()
    p = _params(rc, seed=S)
    x = _x(rc, 2, S, seed=S + 1)
    want = RS.ssd_forward(rc, _j(p), jnp.asarray(x))
    got = ssm.ssd_forward(tc, _t(p), torch.tensor(x))
    assert_close(got, want, f"ssd_forward S={S}")


def test_chunk_rule_is_enforced():
    """S must be below the chunk or a multiple of it, as the reference
    asserts."""
    rc, tc = _cfgs()
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssd_forward(tc, _t(_params(rc, 0)),
                        torch.zeros((1, 24, rc.d_model)))


@pytest.mark.parametrize("S", [5, 32])
def test_final_state_matches_reference(S):
    """The prefill -> decode handoff: h (float32) and the conv tail."""
    rc, tc = _cfgs()
    p = _params(rc, seed=2)
    x = _x(rc, 2, S, seed=3)
    want = RT._ssd_final_state(rc, _j(p), jnp.asarray(x))
    got = ssm.final_state(tc, _t(p), torch.tensor(x))
    assert got.h.dtype == torch.float32
    assert_close(got.h, want.h, "h")
    assert_close(got.conv, want.conv, "conv")


def test_causal_conv_matches_reference():
    rc, tc = _cfgs()
    p = _params(rc, seed=4)
    di, _, ds, dc = ssm._dims(tc)
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 7, di + 2 * ds)).astype(np.float32)
    tail = rng.standard_normal((2, dc - 1, di + 2 * ds)).astype(np.float32)
    for t in (None, tail):
        want, wtail = RS._causal_conv(rc, _j(p), jnp.asarray(xbc),
                                      None if t is None else jnp.asarray(t))
        got, gtail = ssm._causal_conv(tc, _t(p), torch.tensor(xbc),
                                      None if t is None else torch.tensor(t))
        assert_close(got, want, "conv out")
        assert np.array_equal(gtail.numpy(), np.asarray(wtail))


def test_decode_steps_match_reference():
    """Four one-token steps from a random state, state and output each
    step; and steps after ``final_state`` continue ``ssd_forward`` (the
    port against itself over S + 4 tokens)."""
    rc, tc = _cfgs()
    p = _params(rc, seed=6)
    rng = np.random.default_rng(7)
    di, nh, ds, dc = ssm._dims(tc)
    h = rng.standard_normal((2, nh, tc.ssm.head_dim, ds)).astype(np.float32)
    conv = rng.standard_normal((2, dc - 1, di + 2 * ds)).astype(np.float32)
    rst = RS.SSDState(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tst = ssm.SSDState(h=torch.tensor(h), conv=torch.tensor(conv))
    x = _x(rc, 2, 4, seed=8)
    for i in range(4):
        want, rst = RS.ssd_decode_step(rc, _j(p), jnp.asarray(x[:, i:i + 1]),
                                       rst)
        got, tst = ssm.ssd_decode_step(tc, _t(p), torch.tensor(x[:, i:i + 1]),
                                       tst)
        assert_close(got, want, f"step {i} out")
        assert_close(tst.h, rst.h, f"step {i} h")
        assert_close(tst.conv, rst.conv, f"step {i} conv")

    S = 16
    xs = _x(rc, 2, 2 * S, seed=9)
    full = ssm.ssd_forward(tc, _t(p), torch.tensor(xs))
    st = ssm.final_state(tc, _t(p), torch.tensor(xs[:, :S]))
    for i in range(S, S + 4):
        out, st = ssm.ssd_decode_step(tc, _t(p), torch.tensor(xs[:, i:i + 1]),
                                      st)
        assert_close(out[:, 0], full[:, i], f"position {i}")


def test_ssd_gradients_match_reference():
    """d(sum(out * w)) with respect to every parameter and the input, two
    chunks (S = 32)."""
    rc, tc = _cfgs()
    p = _params(rc, seed=10)
    x = _x(rc, 2, 32, seed=11)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)
    gp_ref, gx_ref = jax.grad(
        lambda p, x: jnp.sum(RS.ssd_forward(rc, p, x) * jnp.asarray(w)),
        argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.tensor(x).requires_grad_()
    (ssm.ssd_forward(tc, tp, tx) * torch.tensor(w)).sum().backward()
    assert_close(tx.grad, gx_ref, "d input")
    for k in p:
        assert_close(tp[k].grad, gp_ref[k], f"d {k}")


def test_gradient_stays_finite_where_reference_overflows():
    """With a large step (dt_bias 10, so a chunk's decay sums pass the
    float32 range of exp), the reference's masked ``where(mask, exp(x),
    0)`` has inf above the diagonal, and its gradient there is 0 * inf =
    NaN. The port exponentiates ``where(mask, x, -inf)``: the same forward
    bits, and finite gradients, which agree with a float64 evaluation."""
    rc, tc = _cfgs()
    p = _params(rc, seed=13, dt_bias=10.0)
    x = _x(rc, 1, 32, seed=14)
    want = RS.ssd_forward(rc, _j(p), jnp.asarray(x))
    got = ssm.ssd_forward(tc, _t(p), torch.tensor(x))
    assert_close(got, want, "forward")
    g_ref = jax.grad(lambda p: jnp.sum(RS.ssd_forward(rc, p, jnp.asarray(x))))(
        _j(p))
    assert not np.isfinite(np.asarray(g_ref["in_proj"])).all()
    grads = {}
    for dtype in ("float32", "float64"):
        c = dataclasses.replace(tc, compute_dtype=dtype)
        tp = {k: torch.tensor(v, dtype=getattr(torch, dtype)
                              ).requires_grad_() for k, v in p.items()}
        ssm.ssd_forward(c, tp, torch.tensor(x, dtype=getattr(torch, dtype))
                        ).sum().backward()
        grads[dtype] = {k: v.grad for k, v in tp.items()}
    for k in p:
        assert bool(torch.isfinite(grads["float32"][k]).all()), k
        assert_close(grads["float32"][k], grads["float64"][k].numpy(),
                     f"d {k} against float64", tol=1e-3)


def test_compute_params_keeps_the_ssd_float_leaves():
    """Serving at bfloat16 casts the products' weights but leaves the
    leaves the reference reads as float32 (a_log, dt_bias, d_skip,
    mamba.norm) and the norms unrounded."""
    rc, tc = _cfgs(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import params as P

    tree = P.materialize(transformer.model_specs(tc), gen, device="cpu")
    for leaf in ("a_log", "dt_bias", "d_skip", "norm"):
        tree["blocks"]["pos0"]["mamba"][leaf].normal_(generator=gen)
    comp = transformer.compute_params(tc, tree)
    got = comp["blocks"]["pos0"]["mamba"]
    for leaf in ssm.FLOAT_LEAVES:
        assert got[leaf].dtype == torch.float32, leaf
        assert got[leaf] is tree["blocks"]["pos0"]["mamba"][leaf]
    for leaf in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert got[leaf].dtype == torch.bfloat16, leaf
    assert comp["blocks"]["pos0"]["ln1"]["scale"].dtype == torch.float32
    assert comp["embed"].dtype == torch.bfloat16


def test_serving_reads_the_float_leaves_unrounded():
    """A bfloat16 model whose a_log and dt_bias hold values that bfloat16
    would round: decode and prefill match the reference served from the
    same float32 masters (within the bf16 tolerance), and differ from a
    model whose float leaves were rounded first."""
    rc, tc = _cfgs(compute_dtype="bfloat16", n_layers=1)
    gen = torch.Generator().manual_seed(1)
    from repro_torch.models import params as P

    tree = P.materialize(transformer.model_specs(tc), gen, device="cpu")
    m = tree["blocks"]["pos0"]["mamba"]
    m["a_log"].copy_(torch.linspace(-1.0, 1.0, m["a_log"].numel()) + 1e-3)
    m["dt_bias"].copy_(torch.linspace(-2.0, 2.0, m["dt_bias"].numel())
                       + 1e-3)
    model = transformer.Transformer(tc, tree, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 9)))
    got, _ = model.prefill({"tokens": toks}, 16)
    prm = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                       convert.lm_params_from_numpy(
                           jax.tree.map(lambda t: t.numpy(), tree), tc, "cpu"),
                       is_leaf=torch.is_tensor)
    want, _ = RT.prefill(rc, prm, {"tokens": jnp.asarray(toks.numpy(),
                                                         jnp.int32)}, 16)
    assert_close(got.float(), want, "prefill logits", tol=3e-2)
    rounded = jax.tree.map(lambda t: t.clone(), tree,
                           is_leaf=torch.is_tensor)
    for leaf in ssm.FLOAT_LEAVES:
        t = rounded["blocks"]["pos0"]["mamba"][leaf]
        t.copy_(t.to(torch.bfloat16))
    other, _ = transformer.Transformer(tc, rounded, device="cpu").prefill(
        {"tokens": toks}, 16)
    assert not torch.equal(other, got)
