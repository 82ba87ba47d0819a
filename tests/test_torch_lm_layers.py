"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's on the CPU.

The same seeded numpy inputs and parameters go through the reference's
function and the port's. Tolerance, float32 throughout:
max |port - ref| <= 1e-4 * max |ref| (``TOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro_torch import configs
from repro_torch.models import layers as L

TOL = 1e-4


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu().to(torch.float32) if torch.is_tensor(got)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    scale = np.max(np.abs(want))
    assert err <= tol * scale, f"max|d| {err} > {tol} * max|ref| {scale}"


def _cfgs(arch, **kw):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _pair(a):
    """numpy -> (jax array, torch tensor), float32 unless integer."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _params(rng, shapes: dict, scale=0.5):
    ref, port = {}, {}
    for k, s in shapes.items():
        ref[k], port[k] = _pair(scale * rng.standard_normal(s))
    return ref, port


def _attn_shapes(cfg):
    d, dh, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    sh = {"wq": (d, hq, dh), "wk": (d, hkv, dh), "wv": (d, hkv, dh),
          "wo": (hq, dh, d)}
    if cfg.qkv_bias:
        sh.update(bq=(hq, dh), bk=(hkv, dh), bv=(hkv, dh))
    return sh


@pytest.mark.parametrize("arch", ["granite_8b", "musicgen_medium"])
def test_norm_matches_reference(arch):
    """rmsnorm (granite) and layernorm (musicgen)."""
    rc, tc = _cfgs(arch)
    rng = np.random.default_rng(0)
    x = 3.0 * rng.standard_normal((2, 5, rc.d_model)) + 0.5
    shapes = {"scale": (rc.d_model,)}
    if rc.norm == "layernorm":
        shapes["bias"] = (rc.d_model,)
    pr, pt = _params(rng, shapes, 1.0)
    jx, tx = _pair(x)
    assert_close(L.norm(tc, pt, tx), RL.norm(rc, pr, jx))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 9, 3, 16)))
    for pos in (np.arange(9), np.arange(9) + 37, np.array([5])):
        x = jx[:, :len(pos)], tx[:, :len(pos)]
        jp, tp = _pair(pos)
        assert_close(L.rope(x[1], tp, theta), RL.rope(x[0], jp, theta))


@pytest.mark.parametrize("arch", ["granite_8b", "gemma3_1b",
                                  "musicgen_medium"])
def test_mlp_matches_reference(arch):
    """swiglu (granite), geglu (gemma3) and gelu (musicgen); gelu is the
    tanh approximation."""
    rc, tc = _cfgs(arch)
    rng = np.random.default_rng(2)
    d, f = rc.d_model, rc.d_ff
    shapes = {"w_up": (d, f), "w_down": (f, d)}
    if rc.act in ("swiglu", "geglu"):
        shapes["w_gate"] = (d, f)
    pr, pt = _params(rng, shapes)
    jx, tx = _pair(rng.standard_normal((2, 7, d)))
    assert_close(L.mlp(tc, pt, tx), RL.mlp(rc, pr, jx))


def test_gelu_is_the_tanh_approximation_op_by_op():
    """float32 and bfloat16 inputs: jax.nn.gelu's formula, rounded per op
    in the input's dtype (bfloat16 held bitwise)."""
    rng = np.random.default_rng(3)
    x = (4.0 * rng.standard_normal(4096)).astype(np.float32)
    jx, tx = _pair(x)
    assert_close(L.gelu_tanh(tx), jax.nn.gelu(jx), tol=1e-6)
    got = L.gelu_tanh(tx.to(torch.bfloat16)).to(torch.float32).numpy()
    want = np.asarray(jax.nn.gelu(jx.astype(jnp.bfloat16)), np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunk", [512, 4])
@pytest.mark.parametrize("arch", ["granite_8b", "gemma3_1b"])
def test_gqa_attention_matches_reference(arch, chunk, window):
    """The dense-mask path (attn_chunk 512 > S) and the streaming-softmax
    path (attn_chunk 4 at S = 16: four key chunks), with and without a
    window."""
    rc, tc = _cfgs(arch, attn_chunk=chunk)
    rng = np.random.default_rng(4)
    B, S, hq, hkv, dh = 2, 16, rc.n_heads, rc.n_kv_heads, rc.head_dim
    jq, tq = _pair(2.0 * rng.standard_normal((B, S, hq, dh)))
    jk, tk = _pair(2.0 * rng.standard_normal((B, S, hkv, dh)))
    jv, tv = _pair(rng.standard_normal((B, S, hkv, dh)))
    want = RL.gqa_attention(rc, jq, jk, jv, window=window)
    assert_close(L.gqa_attention(tc, tq, tk, tv, window=window), want)


def test_flash_and_dense_paths_agree_on_the_port():
    rc, tc = _cfgs("gemma3_1b", attn_chunk=4)
    rng = np.random.default_rng(5)
    _, tq = _pair(rng.standard_normal((2, 16, 4, 16)))
    _, tk = _pair(rng.standard_normal((2, 16, 1, 16)))
    _, tv = _pair(rng.standard_normal((2, 16, 1, 16)))
    for w in (None, 3):
        flash = L.gqa_attention(tc, tq, tk, tv, window=w)
        dense = L._gqa_scores_out(tc, tq, tk, tv,
                                  L.causal_mask(16, 16, window=w))
        assert_close(flash, dense.numpy())


@pytest.mark.parametrize("window", [None, 6])
def test_self_attention_matches_reference(window):
    rc, tc = _cfgs("qwen25_14b")   # qkv biases
    rng = np.random.default_rng(6)
    pr, pt = _params(rng, _attn_shapes(rc))
    jx, tx = _pair(rng.standard_normal((2, 11, rc.d_model)))
    want = RL.self_attention(rc, pr, jx, window=window, pos_offset=3)
    assert_close(L.self_attention(tc, pt, tx, window=window, pos_offset=3),
                 want)


def _decode_inputs(rc, rng, T):
    B, hkv, dh = 2, rc.n_kv_heads, rc.head_dim
    pr, pt = _params(rng, _attn_shapes(rc))
    jx, tx = _pair(rng.standard_normal((B, 1, rc.d_model)))
    ck = rng.standard_normal((B, T, hkv, dh)).astype(np.float32)
    cv = rng.standard_normal((B, T, hkv, dh)).astype(np.float32)
    return pr, pt, jx, tx, ck, cv


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_self_attention_matches_reference(pos, window):
    rc, tc = _cfgs("granite_8b")
    rng = np.random.default_rng(7 + pos)
    pr, pt, jx, tx, ck, cv = _decode_inputs(rc, rng, 12)
    out, k2, v2 = RL.decode_self_attention(
        rc, pr, jx, jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        window=window)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = L.decode_self_attention(tc, pt, tx, tck, tcv, pos,
                                          window=window)
    assert gk is tck and gv is tcv    # written in place
    assert_close(got, out)
    assert_close(gk, k2)
    assert_close(gv, v2)


@pytest.mark.parametrize("pos", [2, 7, 8, 13, 30])
def test_decode_local_attention_matches_reference(pos):
    """A rotating window of W = 8 slots, before and after it wraps."""
    rc, tc = _cfgs("gemma3_1b")
    W = rc.sliding_window
    rng = np.random.default_rng(20 + pos)
    pr, pt, jx, tx, ck, cv = _decode_inputs(rc, rng, W)
    out, k2, v2 = RL.decode_local_attention(
        rc, pr, jx, jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos))
    got, gk, gv = L.decode_local_attention(
        tc, pt, tx, torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        pos)
    assert_close(got, out)
    assert_close(gk, k2)
    assert_close(gv, v2)


@pytest.mark.parametrize("local,pos", [(False, 3), (False, 11), (True, 5),
                                       (True, 8), (True, 19)])
@pytest.mark.parametrize("stacked", [True, False])
def test_decode_attention_stacked_matches_reference(stacked, local, pos):
    """The stacked buffer [L, B, T, Hkv, D] written at layer idx, and the
    unstacked one; global (T = 12) and a wrapped local window (W = 8)."""
    rc, tc = _cfgs("gemma3_1b")
    T = rc.sliding_window if local else 12
    rng = np.random.default_rng(40 + pos)
    pr, pt, jx, tx, _, _ = _decode_inputs(rc, rng, T)
    lead = (3,) if stacked else ()
    shape = lead + (2, T, rc.n_kv_heads, rc.head_dim)
    bk = rng.standard_normal(shape).astype(np.float32)
    bv = rng.standard_normal(shape).astype(np.float32)
    idx = 1 if stacked else None
    out, k2, v2 = RL.decode_attention_stacked(
        rc, pr, jx, jnp.asarray(bk), jnp.asarray(bv),
        None if idx is None else jnp.int32(idx), jnp.int32(pos), local=local)
    got, gk, gv = L.decode_attention_stacked(
        tc, pt, tx, torch.from_numpy(bk.copy()), torch.from_numpy(bv.copy()),
        idx, pos, local=local)
    assert_close(got, out)
    assert_close(gk, k2)
    assert_close(gv, v2)


def test_cache_writes_raise_where_the_reference_clamps():
    rc, tc = _cfgs("gemma3_1b")
    rng = np.random.default_rng(9)
    _, pt, _, tx, ck, cv = _decode_inputs(rc, rng, 12)
    ck, cv = torch.from_numpy(ck), torch.from_numpy(cv)
    with pytest.raises(IndexError, match="decode position 12"):
        L.decode_self_attention(tc, pt, tx, ck, cv, 12)
    with pytest.raises(IndexError, match="decode position -1"):
        L.decode_local_attention(tc, pt, tx, ck, cv, -1)
    with pytest.raises(IndexError, match="layer index 3"):
        L.decode_attention_stacked(tc, pt, tx, ck[None].repeat(3, 1, 1, 1, 1),
                                   cv[None].repeat(3, 1, 1, 1, 1), 3, 0,
                                   local=False)


def test_causal_mask_matches_reference():
    for S, T, off, w in ((5, 5, 0, None), (4, 9, 5, None), (6, 6, 0, 2),
                         (3, 10, 7, 4)):
        want = np.asarray(RL.causal_mask(S, T, off, w))
        got = L.causal_mask(S, T, off, w).numpy()
        assert np.array_equal(got, want)
