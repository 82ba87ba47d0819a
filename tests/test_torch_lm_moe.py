"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py`` on the CPU, at the olmoe and arctic smoke
widths.

Parameters are drawn from a numpy seed, normal with each product's
fan-in; inputs are seeded numpy arrays. Tolerances:
* the output and the aux loss, float32: max |port - ref| <= 1e-4 *
  max |ref|;
* the routing (expert index, slot position, kept or dropped) and the
  capacity: equal, ties included (``jax.lax.top_k`` puts the lower index
  first);
* gradients of the parameters and the input through the dispatch
  scatter, the combine gather and the gates: 1e-4 of each leaf's range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as RM
from repro.models import params as RP
from repro_torch import configs
from repro_torch.models import moe

TOL = 1e-4
ARCHS = ["olmoe_1b_7b", "arctic_480b"]


def _cfgs(arch, **moe_kw):
    rc, tc = rconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    if moe_kw:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(rc.moe,
                                                             **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             **moe_kw))
    return rc, tc


def _params(rc, seed: int) -> dict:
    """One MoE layer's parameters (numpy float32), normal with each
    product's fan-in (an expert's [E, in, out] leaf: its ``in``), drawn in
    sorted path order."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(
        RM.moe_specs(rc), is_leaf=lambda s: isinstance(s, RP.PSpec))[0]
    out: dict = {}
    for path, s in flat:
        fan_in = s.shape[-2]
        x = s.scale / np.sqrt(fan_in) * rng.standard_normal(s.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k.key, {})
        node[path[-1].key] = x.astype(np.float32)
    return out


def _x(rc, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, rc.d_model)).astype(np.float32)


def _t(tree):
    return jax.tree.map(torch.tensor, tree)


def _ref_routing(rc, p, x, G):
    """The reference's routing, its own lines (``moe.py:53-87``) run on
    its parameters: (expert_idx, pos, keep, C)."""
    m = rc.moe
    B, S, D = x.shape
    Tg = B * S // G
    xt = jnp.asarray(x).reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xt, jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, m.top_k)
    C = max(1, int(round(Tg * m.top_k * m.capacity_factor / m.n_experts)))
    sel = jax.nn.one_hot(expert_idx, m.n_experts, dtype=jnp.int32)
    flat = sel.reshape(G, Tg * m.top_k, m.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(G, Tg, m.top_k)
    return (np.asarray(expert_idx), np.asarray(pos), np.asarray(pos < C), C)


def _port_routing(tc, p, x, G):
    B, S, D = x.shape
    r = moe.route(tc, _t(p), torch.tensor(x).reshape(G, B * S // G, D))
    return r.expert_idx.numpy(), r.pos.numpy(), r.keep.numpy(), r.capacity


def assert_close(got, want, what, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, G):
    """Output, aux loss and routing integers; two groups split the tokens
    into per-group capacities (olmoe at G = 2: round(8 * 2 * 1.25 / 8) =
    round(2.5) = 2, Python's half-to-even)."""
    rc, tc = _cfgs(arch)
    p = _params(rc, seed=1)
    x = _x(rc, 2, 8, seed=2)
    want, want_aux = RM.moe_ffn(rc, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), num_groups=G)
    got, aux = moe.moe_ffn(tc, _t(p), torch.tensor(x), num_groups=G)
    assert_close(got, want, "out")
    assert aux.dtype == torch.float32
    assert_close(aux, want_aux, "aux")
    ri, rp, rk, rC = _ref_routing(rc, p, x, G)
    gi, gp, gk, gC = _port_routing(tc, p, x, G)
    assert gC == rC == moe.capacity(tc, 16 // G)
    assert np.array_equal(gi, ri) and np.array_equal(gp, rp)
    assert np.array_equal(gk, rk)


def test_capacity_rounds_half_to_even():
    _, tc = _cfgs("olmoe_1b_7b")
    assert [moe.capacity(tc, t) for t in (1, 8, 12, 16, 24)] == [
        1, 2, 4, 5, 8]     # 0.3125 -> 1, 2.5 -> 2, 3.75, 5.0, 7.5 -> 8


def test_top_k_ties_follow_the_lower_index():
    """Router columns duplicated (0 = 1, 2 = 3, ...) with values that make
    every logit exact, so each token's probabilities tie in pairs: the
    port's expert_idx equals ``jax.lax.top_k``'s order (the lower index
    first), and so do the positions, the output and the aux loss."""
    rc, tc = _cfgs("olmoe_1b_7b")
    p = _params(rc, seed=3)
    rng = np.random.default_rng(4)
    E = rc.moe.n_experts
    half = rng.integers(-4, 5, (rc.d_model, E // 2)) * 0.125
    p["router"] = np.repeat(half, 2, axis=1).astype(np.float32)
    x = (rng.integers(-4, 5, (2, 8, rc.d_model)) * 0.25).astype(np.float32)
    ri, rp, rk, _ = _ref_routing(rc, p, x, 1)
    gi, gp, gk, _ = _port_routing(tc, p, x, 1)
    # every token's top-2 is a tied pair, lower index first
    assert np.all(ri[..., 1] == ri[..., 0] + 1) and np.all(ri[..., 0] % 2 == 0)
    assert np.array_equal(gi, ri) and np.array_equal(gp, rp)
    assert np.array_equal(gk, rk)
    want, want_aux = RM.moe_ffn(rc, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x))
    got, aux = moe.moe_ffn(tc, _t(p), torch.tensor(x))
    assert_close(got, want, "out")
    assert_close(aux, want_aux, "aux")


def test_stable_sort_orders_ties_as_top_k():
    """The routing's top-k is the head of a stable descending sort: on
    tied values it takes the lower index first, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order among ties)."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3]])
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    assert srt.indices[0, :2].tolist() == [1, 2]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]
                      ).tolist() == [[1, 2]]


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_slots_like_the_reference(arch):
    """capacity_factor 0.5: slots are dropped (the discard row), and which
    ones, and the output without them, equal the reference's."""
    rc, tc = _cfgs(arch, capacity_factor=0.5)
    p = _params(rc, seed=5)
    x = _x(rc, 2, 8, seed=6)
    ri, rp, rk, rC = _ref_routing(rc, p, x, 1)
    gi, gp, gk, gC = _port_routing(tc, p, x, 1)
    assert gC == rC and not rk.all() and rk.any()
    assert np.array_equal(gk, rk) and np.array_equal(gp, rp)
    want, _ = RM.moe_ffn(rc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, _ = moe.moe_ffn(tc, _t(p), torch.tensor(x))
    assert_close(got, want, "out")


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_reference(arch, G):
    """d(sum(out * w) + aux) with respect to every parameter and the
    input, at the config's capacity (olmoe at G = 2 drops slots): autograd
    through ``index_put`` and the gather against JAX through ``.at[].add``
    and fancy indexing."""
    rc, tc = _cfgs(arch)
    p = _params(rc, seed=7)
    x = _x(rc, 2, 8, seed=8)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        out, aux = RM.moe_ffn(rc, p, x, num_groups=G)
        return jnp.sum(out * jnp.asarray(w)) + aux

    gp_ref, gx_ref = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.tensor(a).requires_grad_(), p)
    tx = torch.tensor(x).requires_grad_()
    out, aux = moe.moe_ffn(tc, tp, tx, num_groups=G)
    ((out * torch.tensor(w)).sum() + aux).backward()
    assert_close(tx.grad, gx_ref, "d input")
    for path, g in jax.tree_util.tree_flatten_with_path(gp_ref)[0]:
        node = tp
        for k in path:
            node = node[k.key]
        assert_close(node.grad, g, "d " + "/".join(k.key for k in path))


def test_group_count_must_divide_the_tokens():
    rc, tc = _cfgs("olmoe_1b_7b")
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(tc, _t(_params(rc, 0)), torch.zeros((1, 5, rc.d_model)),
                    num_groups=2)


def test_bfloat16_silu_values_and_gradients_match_jax():
    """``layers.silu`` in bfloat16 against ``jax.nn.silu`` (XLA's CPU
    compiler expands the logistic op by op, without excess precision):
    the values bit for bit over every bfloat16 input in [-200, 200] (but
    where the input, the sigmoid or the result is subnormal: XLA flushes
    those to zero), and the gradient of sum(silu(x)) finite everywhere
    (autograd through the expansion would be NaN below about -88, where
    an expert's gate overflows exp at full width) and within 1e-2 of
    JAX's (its derivative rule ans * (1 - ans), evaluated in bfloat16
    around a different op order)."""
    import os
    import subprocess
    import sys
    import tempfile

    from repro_torch.models import layers

    bits = np.arange(0, 65536, dtype=np.uint16).view(np.int16)
    x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    a = x.float().abs()
    # XLA flushes subnormal results to zero, torch keeps them: inputs
    # whose silu would be subnormal are left out
    x = x[torch.isfinite(a) & (a <= 200) & ((a >= 1e-36) | (a == 0))]
    xr = x.clone().requires_grad_()
    y = layers.silu(xr)
    (g,) = torch.autograd.grad(y.float().sum(), xr)
    assert bool(torch.isfinite(g.float()).all())
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "x.npy"), x.float().numpy())
        code = (
            "import sys, numpy as np, jax, jax.numpy as jnp\n"
            "x = jnp.asarray(np.load(sys.argv[1])).astype(jnp.bfloat16)\n"
            "y = jax.jit(jax.nn.silu)(x)\n"
            "g = jax.jit(jax.grad(lambda v: jnp.sum(jax.nn.silu(v)"
            ".astype(jnp.float32))))(x)\n"
            "np.save(sys.argv[2], np.asarray(y, np.float32))\n"
            "np.save(sys.argv[3], np.asarray(g, np.float32))\n")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                              + " --xla_allow_excess_precision=false"))
        out = [os.path.join(d, f) for f in ("y.npy", "g.npy")]
        r = subprocess.run([sys.executable, "-c", code,
                            os.path.join(d, "x.npy"), *out],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        want_y, want_g = (np.load(f) for f in out)
    got_y = y.detach().float().numpy()
    # near x = -88 the sigmoid itself is subnormal and XLA flushes it
    ftz = (want_y == 0) & (got_y != 0) & (np.abs(got_y) < 1e-30)
    assert ftz.sum() <= 4
    assert np.array_equal(got_y[~ftz], want_y[~ftz])
    assert np.all(np.isfinite(want_g))
    err = np.abs(g.float().numpy() - want_g)
    assert np.max(err / np.maximum(np.abs(want_g), 1.0)) <= 1e-2
