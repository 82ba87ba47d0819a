"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's ``models/rglru.py`` (and ``transformer._rglru_final_state``) on
the CPU, at the recurrentgemma smoke width (d_model 64, 4 gate blocks of
16, d_conv 4).

Parameters are drawn from a numpy seed: the products normal with a
fan-in of their input width, ``conv_w`` at the reference's 0.1 scale, and
the leaves the reference initialises to constants (``conv_b``, ``b_a``,
``b_x`` zeros, ``lambda_p`` ones) moved off them by U(-1, 1), so every term
of the block is exercised. Inputs are seeded numpy arrays. Tolerances,
float32: max |port - ref| <= 1e-4 * max |ref| for outputs, states and
each gradient leaf; the scan of the same inputs bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import params as RP
from repro.models import rglru as RG
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import rglru

TOL = 1e-4
ARCH = "recurrentgemma_9b"


def _cfgs(**kw):
    return (dataclasses.replace(rconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(configs.get_smoke_config(ARCH), **kw))


def _params(rc, seed: int) -> dict:
    """One RG-LRU layer's parameters (numpy float32) in sorted path
    order."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(
        RG.rglru_specs(rc), is_leaf=lambda s: isinstance(s, RP.PSpec))[0]
    out = {}
    for path, s in flat:
        name = path[-1].key
        if s.init == "normal":
            # the input width of the product: d or di, or a block's bw
            x = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        elif s.init == "scaled":
            x = s.scale * rng.standard_normal(s.shape)
        else:
            base = {"ones": 1.0, "zeros": 0.0}[s.init]
            x = base + rng.uniform(-1.0, 1.0, s.shape)
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


def test_specs_match_reference():
    rc, tc = _cfgs()
    want = RG.rglru_specs(rc)
    got = rglru.rglru_specs(tc)
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert (got[k].shape, got[k].axes, got[k].init, got[k].scale) == (
            s.shape, s.axes, s.init, s.scale), k
    assert rglru._dims(tc) == RG._dims(rc) == (64, 4, 16, 4)


def test_block_linear_and_gates_match_reference():
    """The block-diagonal maps and the gates (a, the gated input) on a
    [B, S, di] float32 input, with b_a, b_x and lambda_p off their inits."""
    rc, tc = _cfgs()
    p = _params(rc, seed=1)
    xr = 2.0 * _x(rc, 2, 7, seed=2)
    want = RG._block_linear(jnp.asarray(p["w_a"]), jnp.asarray(p["b_a"]),
                            jnp.asarray(xr))
    got = rglru._block_linear(torch.tensor(p["w_a"]), torch.tensor(p["b_a"]),
                              torch.tensor(xr))
    assert_close(got, want, "block linear")
    wa, wgx = RG._gates(rc, _j(p), jnp.asarray(xr))
    ga, ggx = rglru._gates(tc, _t(p), torch.tensor(xr))
    assert ga.dtype == ggx.dtype == torch.float32
    assert_close(ga, wa, "a")
    assert_close(ggx, wgx, "gated x")


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_causal_conv_and_its_tail_match_reference(S):
    """The conv and the tail it hands to decode, from the zero pad and
    from a given tail: for S < d_conv - 1 = 3 the tail keeps the pad's (or
    the old tail's) last rows, bit for bit."""
    rc, tc = _cfgs()
    p = _params(rc, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    old = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for tail in (None, old):
        want, wtail = RG._causal_conv(
            rc, _j(p), jnp.asarray(x), None if tail is None else jnp.asarray(
                tail))
        got, gtail = rglru._causal_conv(
            tc, _t(p), torch.tensor(x), None if tail is None
            else torch.tensor(tail))
        assert_close(got, want, f"conv S={S}")
        assert gtail.shape == (2, 3, 64)
        assert np.array_equal(gtail.numpy(), np.asarray(wtail))


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 13, 64, 257])
def test_scan_matches_associative_scan_bitwise(S):
    """The recursion of ``jax.lax.associative_scan``, its combine's
    multiply-add fused as XLA fuses it: the same bits for h at every
    length, odd ones included (the products of a are compared where they
    are normal numbers: XLA's CPU code flushes subnormals to zero)."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = rng.standard_normal((2, S, 16)).astype(np.float32)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, b1 * a2 + b2

    wa, wh = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    ga, gh = rglru.scan(torch.tensor(a), torch.tensor(b))
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    normal = np.abs(np.asarray(wa)) >= np.finfo(np.float32).tiny
    assert np.array_equal(ga.numpy()[normal], np.asarray(wa)[normal])
    # and it is the recurrence
    h = np.zeros((2, 16), np.float64)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(gh[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 8, 64])
def test_rglru_forward_matches_reference(S):
    rc, tc = _cfgs()
    p = _params(rc, seed=S)
    x = _x(rc, 2, S, seed=S + 1)
    want = RG.rglru_forward(rc, _j(p), jnp.asarray(x))
    got = rglru.rglru_forward(tc, _t(p), torch.tensor(x))
    assert_close(got, want, f"rglru_forward S={S}")


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_final_state_matches_reference(S):
    """The prefill -> decode handoff: h (float32) and the conv tail
    (compute dtype), short prompts' tails holding the zero pad; and the
    one-pass prefill gives the same bits as ``final_state`` and
    ``rglru_forward``."""
    rc, tc = _cfgs()
    p = _params(rc, seed=5)
    x = _x(rc, 2, S, seed=6)
    want = RT._rglru_final_state(rc, _j(p), jnp.asarray(x))
    got = rglru.final_state(tc, _t(p), torch.tensor(x))
    assert got.h.dtype == torch.float32 and got.h.shape == (2, 64)
    assert got.conv.shape == (2, 3, 64)
    assert_close(got.h, want.h, "h")
    assert_close(got.conv, want.conv, "conv")
    if S < 3:
        assert not got.conv[:, :3 - S].any()
    out, st = rglru.rglru_prefill(tc, _t(p), torch.tensor(x))
    assert torch.equal(out, rglru.rglru_forward(tc, _t(p), torch.tensor(x)))
    assert torch.equal(st.h, got.h) and torch.equal(st.conv, got.conv)


def test_decode_steps_match_reference():
    """Four one-token steps from a random state: the output, h and the
    conv tail each step."""
    rc, tc = _cfgs()
    p = _params(rc, seed=7)
    rng = np.random.default_rng(8)
    h = rng.standard_normal((2, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    rst = RG.RGLRUState(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tst = rglru.RGLRUState(h=torch.tensor(h), conv=torch.tensor(conv))
    x = _x(rc, 2, 4, seed=9)
    for i in range(4):
        want, rst = RG.rglru_decode_step(rc, _j(p), jnp.asarray(
            x[:, i:i + 1]), rst)
        got, tst = rglru.rglru_decode_step(tc, _t(p), torch.tensor(
            x[:, i:i + 1]), tst)
        assert_close(got, want, f"step {i} out")
        assert_close(tst.h, rst.h, f"step {i} h")
        assert_close(tst.conv, rst.conv, f"step {i} conv")


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_decode_after_prefill_continues_forward(S):
    """On the port: decode steps after ``final_state`` of S tokens equal
    ``rglru_forward`` over S + 4 at the same positions, short prompts (whose
    tail holds the pad) included."""
    rc, tc = _cfgs()
    p = _t(_params(rc, seed=10))
    xs = torch.tensor(_x(rc, 2, S + 4, seed=11))
    full = rglru.rglru_forward(tc, p, xs)
    st = rglru.final_state(tc, p, xs[:, :S])
    for i in range(S, S + 4):
        out, st = rglru.rglru_decode_step(tc, p, xs[:, i:i + 1], st)
        assert_close(out[:, 0], full[:, i].numpy(), f"position {i}")


def test_rglru_gradients_match_reference():
    """d(sum(out * w)) with respect to every parameter and the input at
    float32, S = 13."""
    rc, tc = _cfgs()
    p = _params(rc, seed=12)
    x = _x(rc, 2, 13, seed=13)
    w = np.random.default_rng(14).standard_normal(x.shape).astype(np.float32)
    gp_ref, gx_ref = jax.grad(
        lambda p, x: jnp.sum(RG.rglru_forward(rc, p, x) * jnp.asarray(w)),
        argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.tensor(x).requires_grad_()
    (rglru.rglru_forward(tc, tp, tx) * torch.tensor(w)).sum().backward()
    assert_close(tx.grad, gx_ref, "d input")
    for k in p:
        assert_close(tp[k].grad, gp_ref[k], f"d {k}")


def test_rglru_float64_gradients_are_the_derivative():
    """At float64 compute (gates and scan in float64) the autograd
    gradients of the block, through the scan's strided slices, the fused
    multiply-adds and the conv, equal central differences
    (``torch.autograd.gradcheck``) with respect to the input, the biases,
    Lambda and a gate's block weights, at a narrow width (d_model 16, 2
    blocks of 8) and S = 6 (odd and even levels of the scan)."""
    _, tc = _cfgs(d_model=16, n_heads=2, compute_dtype="float64")
    rc, _ = _cfgs(d_model=16, n_heads=2)
    p = {k: torch.tensor(v, dtype=torch.float64)
         for k, v in _params(rc, seed=15).items()}
    x = torch.tensor(_x(rc, 1, 6, seed=16), dtype=torch.float64)
    names = ("conv_b", "b_a", "b_x", "lambda_p", "w_a")

    def f(x, *leaves):
        q = dict(p, **dict(zip(names, leaves)))
        return rglru.rglru_forward(tc, q, x)

    args = [x.requires_grad_()] + [p[k].clone().requires_grad_()
                                   for k in names]
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-7, rtol=1e-5)
