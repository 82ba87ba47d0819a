"""The port's LM training path against the JAX package's on the CPU: the
streaming-softmax backward, ``loss_fn`` and its gradients, ``train_step``
over three steps (AdamW, SGD, microbatches, gradient compression), remat,
bfloat16 training, the LM online-adapt FSM and the launcher.

The state comes from a numpy seed with the reference's initialisers, each
layer's from its own spec (``np_params``), with the leaves whose constant
inits would hide a fault moved off them (a CROSS layer's ``gate`` and
``ffn_gate``, zeros, zero its branches' gradients; the RG-LRU's
``conv_b``, ``b_a``, ``b_x``, ``lambda_p``). A vlm batch carries
``cross_embeds``. Tolerances (float32 compute):
* the loss: |port - ref| <= 1e-5 * |ref|;
* the flash backward's dq, dk, dv, every gradient leaf, and the
  parameters and moments after each of 3 steps: max |port - ref| <= 1e-4
  * max |ref| of the leaf (the gradient test prints its worst leaf);
* at ``materialize``'s own init a stacked leaf's fan-in is its super-block
  count (std 1 for gemma3's single super-block), and there float32
  gradients are ill-conditioned: the reference's own lie more than 1e-4
  of a leaf's range from a float64 evaluation, and so do the port's
  (``test_stacked_init_float32_gradients_are_ill_conditioned`` measures
  both); so the parity tests draw each stacked layer with its layer's
  fan-in, as the remainder layers are drawn;
* bfloat16 (gemma3, the reference in a fresh process with
  ``--xla_allow_excess_precision=false``): 3e-2 of each leaf's range.
* remat none / full / dots: gradients equal bit for bit.
"""
import dataclasses
import functools
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
from repro.models import layers as RL
from repro.models import params as RP
from repro.models import transformer as RT
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import configs, convert
from repro_torch import tree as T
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers
from repro_torch.models import params as P
from repro_torch.models import stubs, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as TS

TOL = 1e-4
LOSS_TOL = 1e-5
TOL_BF16 = 3e-2
DENSE = ["granite_8b", "gemma3_1b", "phi3_medium_14b", "qwen25_14b",
         "musicgen_medium"]
MOE_SSD = ["olmoe_1b_7b", "arctic_480b", "mamba2_780m"]
RGLRU_CROSS = ["recurrentgemma_9b", "llama32_vision_11b"]
B, S = 2, 32


def np_params(rc, seed: int, per_layer: bool = True) -> dict:
    """Parameters from a numpy seed with the reference's initialisers,
    drawn leaf by leaf in sorted path order. ``per_layer``: a stacked
    leaf's fan-in is that of one layer's spec (as for the unstacked
    remainder layers), not ``materialize``'s leading super-block count.
    The CROSS gates and the RG-LRU's constant-init leaves get U(-1, 1)
    added, from a second generator (the other leaves' draws are as
    before)."""
    rng = np.random.default_rng(seed)
    off = np.random.default_rng([seed, 1])
    specs = RT.model_specs(rc)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, RP.PSpec))[0]
    out: dict = {}
    for path, s in flat:
        if s.init == "zeros":
            x = np.zeros(s.shape)
        elif s.init == "ones":
            x = np.ones(s.shape)
        elif s.init == "normal":
            shape = (s.shape[1:] if per_layer and s.axes[0] == "layers"
                     else s.shape)
            fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
            x = s.scale / np.sqrt(fan_in) * rng.standard_normal(s.shape)
        else:
            x = s.scale * rng.standard_normal(s.shape)
        keys = [k.key for k in path]
        if keys[-1] in ("gate", "ffn_gate") or (
                "rec" in keys and keys[-1] in ("conv_b", "b_a", "b_x",
                                               "lambda_p")):
            x = x + off.uniform(-1.0, 1.0, s.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k.key, {})
        node[path[-1].key] = x.astype(np.float32)
    return out


def np_batch(rc, seed: int, b: int = B, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    if rc.embeds_input:
        out = {"embeds": (0.02 * rng.standard_normal(
            (b, s, rc.d_model))).astype(np.float32),
            "labels": rng.integers(0, rc.vocab_size, (b, s)).astype(np.int32)}
    else:
        out = {"tokens": rng.integers(0, rc.vocab_size, (b, s)).astype(
            np.int32)}
    if rc.family == "vlm":
        out["cross_embeds"] = (0.5 * rng.standard_normal(
            (b, rc.n_cross_tokens, rc.d_model))).astype(np.float32)
    return out


def _cfgs(arch, **kw):
    return (dataclasses.replace(rconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _port_tree(tree: dict) -> dict:
    """numpy -> CPU tensors (copies: the port may update them in place)."""
    return T.map(lambda x: torch.tensor(x), tree)


def _flat(tree) -> list:
    """(path, numpy leaf) of a reference or port tree, reference order."""
    return [("/".join(str(getattr(k, "key", getattr(k, "name", "")))
                      for k in path),
             np.asarray(leaf.detach().float() if torch.is_tensor(leaf)
                        else leaf, np.float64))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)
    assert err <= tol, f"{what}: {err:.3e} > {tol}"
    return err


def _close_trees(got, want, tol, what, allow=None, range_of=1.0):
    """Leaf by leaf, relative to ``range_of`` x each reference leaf's max
    |value|; the flat indices in ``allow[path]`` are left out."""
    fg, fw = _flat(got), _flat(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    worst = 0.0
    for (p, a), (_, b) in zip(fg, fw):
        scale = range_of * np.max(np.abs(b)) or 1.0
        keep = np.ones(a.size, bool)
        keep[sorted((allow or {}).get(p, ()))] = False
        err = np.max(np.abs(a - b).reshape(-1)[keep], initial=0.0) / scale
        assert err <= tol, f"{what} {p}: {err:.3e} > {tol}"
        worst = max(worst, err)
    return worst


def _add_flips(flips: dict, port_res, ref_res) -> None:
    """Gradient compression quantises each element to an int8 level; where
    (gradient + residual) / scale sits within float error of a
    half-integer, the packages' last-bit differences round it to adjacent
    levels, and the element's dequantised gradient (so its moments and,
    through the residual, later steps) differs by one quantum. Such an
    element shows as residuals that differ by more than half a quantum
    (2 max |residual| is one quantum); record them per leaf."""
    for (p, a), (_, b) in zip(_flat(port_res), _flat(ref_res)):
        quantum = 2 * np.max(np.abs(b))
        idx = np.nonzero(np.abs(a - b).reshape(-1) > 0.5 * quantum)[0]
        flips.setdefault(p, set()).update(int(i) for i in idx)


# -- the streaming-softmax backward ---------------------------------------


@pytest.mark.parametrize("window", [None, 5, 8])
def test_flash_backward_matches_reference(window):
    """dq, dk, dv of ``_Flash`` against ``jax.vjp`` of the reference's
    ``_flash_fn`` at smoke width (4 heads of 16, one kv head), chunk 8,
    S = 32: GLOBAL and two LOCAL windows, whose warm-up rows have fully
    masked first chunks."""
    rng = np.random.default_rng(0 if window is None else window)
    q, do = (rng.standard_normal((B, S, 4, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, 1, 16)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(RL._flash_fn(window, 8), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    got_out = layers._Flash.apply(tq, tk, tv, window, 8)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.tensor(do))
    _close(got_out.detach(), out, TOL, "out")
    for name, g, w in zip("qkv", got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, TOL, f"d{name}")


def test_flash_path_is_taken_and_differentiable():
    """gqa_attention takes the streaming path above attn_chunk and its
    gradients equal the dense path's (a shorter chunk changes only the
    order of the sums)."""
    _, tc = _cfgs("gemma3_1b")
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((1, S, 4, 16)), dtype=torch.float64)
    k, v = (torch.tensor(rng.standard_normal((1, S, 1, 16)),
                         dtype=torch.float64) for _ in range(2))
    grads = []
    for chunk in (8, S):
        c = dataclasses.replace(tc, attn_chunk=chunk)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = layers.gqa_attention(c, *xs, window=8)
        assert (o.grad_fn.name() == "_FlashBackward") == (chunk == 8)
        grads.append(torch.autograd.grad(o.square().sum(), xs))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)


# -- loss_fn and its gradients ---------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(rc, num_groups=1):
    return jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(rc, p, b, num_groups=num_groups),
        has_aux=True))


def _ref_loss_and_grads(rc, prm, batch, num_groups=1):
    (loss, parts), grads = _ref_value_and_grad(rc, num_groups)(prm, batch)
    return float(loss), parts, grads


def _port_grads(tc, tree, batch, dtype=None, num_groups=1):
    c = tc if dtype is None else dataclasses.replace(tc, compute_dtype=dtype)
    return TS.grad_fn(c, TS.TrainConfig(moe_num_groups=num_groups), tree,
                      T.map(torch.tensor, batch))


@pytest.mark.parametrize("arch,chunk", [(a, 512) for a in DENSE + MOE_SSD
                                        + RGLRU_CROSS]
                         + [("gemma3_1b", 8), ("recurrentgemma_9b", 8)])
def test_loss_and_grads_match_reference(arch, chunk):
    """The five dense smoke configs (S = 32, the dense attention path),
    gemma3 with attn_chunk 8 (every layer on the streaming path), the two
    MoE configs (the router aux loss in the loss; the gradients through
    the dispatch and the gates), mamba2 (two 16-token SSD chunks),
    recurrentgemma (the RG-LRU scan's backward; with attn_chunk 8 its
    LOCAL layer streams) and llama-vision (the gradients of the CROSS
    layer's weights and gates, and through ``cross_embeds``' projections)."""
    _loss_and_grads(arch, chunk, 1)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "arctic_480b"])
def test_moe_groups_loss_and_grads_match_reference(arch):
    """The MoE configs with two dispatch groups
    (``TrainConfig.moe_num_groups``), each with its own capacity."""
    _loss_and_grads(arch, 512, 2)


def _loss_and_grads(arch, chunk, groups):
    rc, tc = _cfgs(arch, attn_chunk=chunk)
    prm = np_params(rc, seed=11)
    batch = np_batch(rc, seed=12)
    loss, parts, want = _ref_loss_and_grads(
        rc, jax.tree.map(jnp.asarray, prm), jax.tree.map(jnp.asarray, batch),
        groups)
    tree = _port_tree(prm)
    got_loss, got_parts, got = _port_grads(tc, tree, batch,
                                           num_groups=groups)
    assert abs(got_loss.item() - loss) <= LOSS_TOL * abs(loss)
    assert abs(got_parts["ce"].item() - float(parts["ce"])) <= (
        LOSS_TOL * abs(loss))
    if rc.moe is None:
        assert got_parts["aux"].item() == float(parts["aux"]) == 0.0
    else:
        aux = float(parts["aux"])
        assert aux > 0
        assert abs(got_parts["aux"].item() - aux) <= LOSS_TOL * aux
    assert all(g.dtype == torch.float32 for g in T.leaves(got))
    worst = _close_trees(got, want, TOL, f"{arch} gradient")
    print(f"{arch} chunk {chunk}: loss {abs(got_loss.item() - loss) / loss:.2e}"
          f" relative, worst gradient leaf {worst:.2e} of its range")


def test_stacked_init_float32_gradients_are_ill_conditioned():
    """gemma3 smoke at ``materialize``'s init (stacked fan-in = 1 super-
    block): the loss still agrees within 1e-5, but the float32 gradients of
    both packages miss a float64 evaluation (the port's, at float64
    compute) by more than 1e-4 of some leaf's range. Prints both worst
    errors."""
    rc, tc = _cfgs("gemma3_1b")
    prm = np_params(rc, seed=11, per_layer=False)
    batch = np_batch(rc, seed=12, b=4)
    loss, _, want = _ref_loss_and_grads(
        rc, jax.tree.map(jnp.asarray, prm), jax.tree.map(jnp.asarray, batch))
    tree = _port_tree(prm)
    got_loss, _, got = _port_grads(tc, tree, batch)
    _, _, truth = _port_grads(tc, tree, batch, "float64")
    assert abs(got_loss.item() - loss) <= LOSS_TOL * abs(loss)
    err = {}
    for name, tr in (("port", got), ("reference", want)):
        err[name] = max(np.max(np.abs(a - t)) / np.max(np.abs(t))
                        for (_, a), (_, t) in zip(_flat(tr), _flat(truth)))
    print(f"stacked init, worst leaf against float64: port {err['port']:.3e}"
          f", reference {err['reference']:.3e}")
    assert err["port"] > TOL and err["reference"] > TOL, err


def test_bfloat16_cast_covers_the_norm_scales():
    """``cast_for_compute`` casts every float32 leaf, the norm scales too
    (serving's ``compute_params`` keeps them float32): bfloat16 training
    gets bfloat16 gradients for every leaf."""
    rc, tc = _cfgs("gemma3_1b", compute_dtype="bfloat16")
    tree = _port_tree(np_params(rc, seed=1))
    cast = TS.cast_for_compute(tc, tree)
    assert cast["final_norm"]["scale"].dtype == torch.bfloat16
    assert cast["blocks"]["pos0"]["ln1"]["scale"].requires_grad
    assert cast["blocks"]["pos0"]["ln1"]["scale"].is_leaf
    assert transformer.compute_params(tc, tree)["final_norm"]["scale"].dtype \
        == torch.float32
    _, _, g = TS.grad_fn(tc, TS.TrainConfig(), tree,
                         T.map(torch.tensor, np_batch(rc, 2)))
    assert {x.dtype for x in T.leaves(g)} == {torch.bfloat16}


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_equal_without_remat(remat):
    """Remat changes memory only: the same ops recompute the same values,
    so the gradients (and the loss) are the same bits; on the streaming
    path too."""
    out = []
    for mode in ("none", remat):
        rc, tc = _cfgs("gemma3_1b", remat=mode, attn_chunk=8)
        out.append(TS.grad_fn(tc, TS.TrainConfig(),
                              _port_tree(np_params(rc, 3)),
                              T.map(torch.tensor, np_batch(rc, 4))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(T.leaves(out[0][2]), T.leaves(out[1][2])):
        assert torch.equal(a, b)


def test_remat_dots_keeps_only_matrix_products():
    """The dots policy saves ``aten.mm`` outputs (the contractions with no
    batch dims) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    assert transformer._save_dots(None, torch.ops.aten.mm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default,
               torch.ops.aten.mul.Tensor):
        assert transformer._save_dots(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE


# -- train_step over three steps ------------------------------------------

STEP_CASES = {
    "adamw": {},
    "sgd": {"opt": {"name": "sgd"}},
    "microbatches": {"microbatches": 2},
    "grad_compress": {"grad_compress": True},
    "moe_groups": {"moe_num_groups": 2},
}


def _train_cfgs(case):
    kw = dict(STEP_CASES[case])
    o = dict(lr=1e-3, warmup_steps=1, total_steps=100, **kw.pop("opt", {}))
    return (RTS.TrainConfig(opt=RO.OptConfig(**o), **kw),
            TS.TrainConfig(opt=opt.OptConfig(**o), **kw))


_PARTS = {"params": lambda s: s.params, "mu": lambda s: s.opt.mu,
          "nu": lambda s: s.opt.nu,
          "residual": lambda s: s.compress.residual}


@pytest.mark.parametrize("case", [c for c in STEP_CASES
                                  if c != "moe_groups"])
def test_train_step_three_steps_match_reference(case):
    """gemma3 smoke, 3 steps on 3 batches: losses within 1e-5, the learning
    rate and step bitwise, the gradient norm within 1e-5, parameters and
    moments (and the compression residual) within 1e-4 of each leaf's
    range after every step."""
    _three_steps("gemma3_1b", case)


@pytest.mark.parametrize("arch,case",
                         [(a, c) for a in MOE_SSD
                          for c in ("adamw", "microbatches")]
                         + [("olmoe_1b_7b", "moe_groups"),
                            ("arctic_480b", "moe_groups")]
                         + [(a, c) for a in RGLRU_CROSS
                            for c in ("adamw", "microbatches")])
def test_moe_ssd_train_steps_match_reference(arch, case):
    """The MoE, SSD, RG-LRU and vlm smoke configs, 3 AdamW steps as the
    gemma3 test: one batch a step, two microbatches a step (a vlm's
    ``cross_embeds`` split along B with its tokens), and (MoE) two dispatch
    groups (``moe_num_groups``, whose per-group capacity drops other
    slots). The embeddings of these configs carry gradients at noise
    level, which AdamW moves by about lr whatever their size: such
    elements are held to the gap the two runs' moments imply
    (:func:`_adamw_gaps`, printed), the rest to TOL."""
    _three_steps(arch, case, implied=True)


def _adamw_gaps(host, ref, prev, lr: float, t: int, oc, amplified: dict):
    """AdamW's parameter gap as the two runs' moments imply it. Each
    element moves by lr * m_hat / (sqrt(v_hat) + eps), about lr whatever
    the gradient's size, so a gradient at noise level (within TOL of its
    leaf's range in both runs, yet a different number) moves the two
    parameters apart by far more than TOL of their range, step after
    step. Where the gap that the moments imply, (p_port - p_ref)_prev *
    (1 - lr wd) - lr * (u_port - u_ref), exceeds TOL of the leaf's range
    (and from then on), the gap is replaced by its distance from that
    implied gap. Returns the port's parameters so adjusted
    (the reference's stay as they are); ``amplified`` collects the flat
    indices per leaf."""
    b1, b2 = 1.0 - oc.b1 ** t, 1.0 - oc.b2 ** t
    out = {}
    leaves = zip(_flat(host.params), _flat(ref.params), _flat(prev[0]),
                 _flat(prev[1]), _flat(host.opt.mu), _flat(ref.opt.mu),
                 _flat(host.opt.nu), _flat(ref.opt.nu))
    for (p, a), (_, b), (_, a0), (_, b0), (_, mh), (_, mr), (_, vh), \
            (_, vr) in leaves:
        du = ((mh / b1) / (np.sqrt(vh / b2) + oc.eps)
              - (mr / b1) / (np.sqrt(vr / b2) + oc.eps))
        pred = (a0 - b0) * (1.0 - lr * oc.weight_decay) - lr * du
        amp = amplified.setdefault(p, set())
        amp.update(np.nonzero(np.abs(pred).reshape(-1)
                              > TOL * np.max(np.abs(b)))[0].tolist())
        adj = a.reshape(-1).copy()
        idx = sorted(amp)
        adj[idx] = b.reshape(-1)[idx] + (a - b - pred).reshape(-1)[idx]
        out[p] = adj.reshape(a.shape)
    return out


def _three_steps(arch, case, implied=False):
    rc, tc = _cfgs(arch)
    rtc, ttc = _train_cfgs(case)
    prm = np_params(rc, seed=21)
    rstate = RTS.init_state(rtc, jax.tree.map(jnp.asarray, prm))
    tstate = TS.init_state(ttc, _port_tree(prm))
    step = jax.jit(lambda s, b: RTS.train_step(rc, rtc, s, b))
    flips: dict = {}
    amplified: dict = {}
    prev = (prm, prm)
    for i in range(3):
        batch = np_batch(rc, seed=30 + i, b=4)
        rstate, rm = step(rstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = TS.train_step(tc, ttc, tstate, batch, donate=bool(i % 2))
        assert abs(tm["loss"].item() - float(rm["loss"])) <= (
            LOSS_TOL * float(rm["loss"]))
        assert np.float32(rm["lr"]) == tm["lr"].item()
        assert abs(tm["grad_norm"].item() - float(rm["grad_norm"])) <= (
            LOSS_TOL * float(rm["grad_norm"]))
        assert int(tstate.opt.step) == int(rstate.opt.step) == i + 1
        host = convert.lm_train_state_to_numpy(tstate)
        ref = jax.tree.map(np.asarray, rstate)
        assert (host.compress is None) == (ref.compress is None)
        if host.compress is not None:
            _add_flips(flips, host.compress.residual, ref.compress.residual)
        for part, get in _PARTS.items():
            if host.compress is None and part == "residual":
                continue
            got = get(host)
            if implied and part == "params" and ttc.opt.name == "adamw":
                got = _adamw_gaps(host, ref, prev, float(rm["lr"]), i + 1,
                                  ttc.opt, amplified)
                got = T.unflatten(get(ref), [got[p] for p, _ in
                                             _flat(get(ref))])
            # the residual is the gradient less its int8 level: it carries
            # the gradient's absolute error, so it is held to the
            # gradient's range (127 quanta = 254 x its own max)
            _close_trees(got, get(ref), TOL,
                         f"{case} step {i + 1} {part}", allow=flips,
                         range_of=254.0 if part == "residual" else 1.0)
        # a copy: the next step may donate (write) the port's tensors
        prev = (jax.tree.map(np.array, host.params), ref.params)
    n_amp = sum(map(len, amplified.values()))
    if n_amp:
        print(f"{arch} {case}: {n_amp} parameters held to AdamW's step "
              "difference implied by the two runs' moments: "
              + "; ".join(f"{p}: {sorted(v)[:4]}" for p, v in
                          amplified.items() if v))
    if flips:
        print(f"{case}: int8 levels that differ (leaf: flat indices): "
              + "; ".join(f"{p}: {sorted(v)[:4]}" for p, v in flips.items()
                          if v))
        if case == "grad_compress":
            err = float(rm["compress_err_l1"])
            assert abs(tm["compress_err_l1"].item() - err) <= LOSS_TOL * err


def test_microbatches_average_the_parts():
    """Two microbatches of one row each: the loss is the mean of the two
    one-row losses and the gradients the mean of theirs, in float32."""
    rc, tc = _cfgs("granite_8b")
    tree = _port_tree(np_params(rc, 5))
    batch = np_batch(rc, 6)
    loss, parts, grads = TS.grad_fn(tc, TS.TrainConfig(microbatches=2), tree,
                                    batch)
    one = [TS.grad_fn(tc, TS.TrainConfig(), tree,
                      {k: v[i:i + 1] for k, v in batch.items()})
           for i in range(2)]
    assert loss.item() == ((one[0][0] + one[1][0]) * 0.5).item()
    assert parts["ce"].item() == loss.item()
    for g, a, b in zip(T.leaves(grads), T.leaves(one[0][2]),
                       T.leaves(one[1][2])):
        assert g.dtype == torch.float32
        assert torch.equal(g, (a + b) * 0.5)


# -- bfloat16 against the reference (fresh process) -----------------------

_BF16_REFERENCE = textwrap.dedent("""\
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro import configs
    from repro.models import transformer
    from repro.train import optimizer as RO
    from repro.train import train_step as RTS

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
    tc = RTS.TrainConfig(opt=RO.OptConfig(lr=1e-3, warmup_steps=1))
    grad = jax.jit(lambda p, b: jax.grad(lambda q: transformer.loss_fn(
        cfg, RTS.cast_for_compute(cfg, q), b)[0])(p))
    step = jax.jit(lambda s, b: RTS.train_step(cfg, tc, s, b))
    out = {}
    st = RTS.init_state(tc, prm)
    for i in range(2):
        bi = {"tokens": jnp.asarray(z[f"t{i}"])}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                grad(st.params, bi))[0]:
            out[f"g{i}/" + "/".join(k.key for k in path)] = leaf
        st, m = step(st, bi)
        out[f"loss{i}"] = m["loss"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(st.params)[0]:
        out["p2/" + "/".join(k.key for k in path)] = leaf
    np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in out.items()})
""")


def test_gemma3_bfloat16_training_matches_reference(tmp_path):
    """gemma3 smoke at bfloat16 compute, 2 AdamW steps: the first step's
    gradients (bfloat16 gradients of the bfloat16 copy, norms included),
    both steps' losses and the parameters after both within TOL_BF16 of
    the reference run with XLA's excess-precision license off (as the
    serving test)."""
    rc, tc = _cfgs("gemma3_1b", compute_dtype="bfloat16")
    prm = np_params(rc, seed=41)
    toks = [np_batch(rc, seed=42 + i)["tokens"] for i in range(2)]
    flat = {"p/" + "/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(prm)[0]}
    np.savez(tmp_path / "in.npz", t0=toks[0], t1=toks[1], **flat)
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

    ttc = TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1))
    st = TS.init_state(ttc, _port_tree(prm))
    flips: dict = {}
    for i in range(2):
        b = {"tokens": toks[i]}
        _, _, g = TS.grad_fn(tc, ttc, st.params, b)
        assert {x.dtype for x in T.leaves(g)} == {torch.bfloat16}
        for path, x in _flat(g):
            y = want[f"g{i}/" + path].reshape(-1)
            x = x.reshape(-1)
            if i == 0:  # step 2 starts from states that differ where
                # step 1's Adam flips moved them (below)
                _close(x, y, TOL_BF16, f"step 1 gradient {path}")
            idx = np.nonzero(np.sign(x) != np.sign(y))[0]
            # only where both gradients are noise at this dtype
            scale = np.max(np.abs(y))
            assert np.all(np.abs(x[idx]) <= TOL_BF16 * scale), path
            assert np.all(np.abs(y[idx]) <= TOL_BF16 * scale), path
            flips.setdefault(path, set()).update(int(j) for j in idx)
            if i == 0 and len(idx):
                j = int(idx[0])
                print(f"step 1 {path}: {len(idx)} gradients of opposite "
                      f"sign, e.g. [{j}] port {x[j]:.3e} reference "
                      f"{y[j]:.3e} (leaf max {scale:.3e})")
        st, m = TS.train_step(tc, ttc, st, b)
        _close(m["loss"].item(), want[f"loss{i}"], TOL_BF16, f"loss {i}")
    # AdamW moves each element by about lr * sign(gradient) whatever its
    # size, so an element whose two gradients are noise of opposite signs
    # ends up about 2 lr apart; those are left out of the parameter check
    # (and counted above), every other element is held to TOL_BF16.
    worst = _close_trees(st.params,
                         {p: want["p2/" + p] for p, _ in _flat(st.params)},
                         TOL_BF16, "param", allow=flips)
    n = sum(x.numel() for x in T.leaves(st.params))
    print(f"bf16: {sum(map(len, flips.values()))} of {n} parameters left out"
          f" (opposite-sign noise gradients); the rest within {worst:.2e}")


# -- the LM online-adapt FSM and the launcher ------------------------------


def test_online_adapt_rollback(tmp_path):
    """The twin of tests/test_serving.py::test_online_adapt_rollback:
    degraded eval loss triggers a rollback to the best checkpoint."""
    from repro_torch.serve.online_adapt import (OnlineAdaptConfig,
                                                OnlineAdaptManager)

    cfg = configs.get_smoke_config("gemma3_1b")
    gen = torch.Generator().manual_seed(0)
    prm = P.materialize(transformer.model_specs(cfg), gen, device="cpu")
    tc = TS.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=1000))
    oc = OnlineAdaptConfig(analyze_every=2, rollback_threshold=0.05,
                           checkpoint_dir=str(tmp_path))
    m = OnlineAdaptManager(cfg, tc, TS.init_state(tc, prm), oc, device="cpu")

    shape = ShapeConfig("t", 32, 2, "train")
    good = stubs.synthetic_batch(cfg, shape, seed=1, device="cpu")
    evalb = stubs.synthetic_batch(cfg, shape, seed=2, device="cpu")
    m.offline_train([good, good], evalb)
    base_loss = m.history[-1][1]
    saved = convert.lm_train_state_to_numpy(m.state)

    bad = dict(good)
    bad["tokens"] = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    tc_bad = dataclasses.replace(tc, opt=dataclasses.replace(tc.opt, lr=0.5))
    m._update = lambda s, b: TS.train_step(cfg, tc_bad, s, b)
    for _ in range(6):
        m.online_step(bad, evalb)
    assert m.rollbacks >= 1, (m.history, base_loss)
    # the last analysis rolled back too: the state is the offline one,
    # bit for bit
    assert m.history[-1][1] > base_loss * (1 + oc.rollback_threshold)
    now = convert.lm_train_state_to_numpy(m.state)
    for (pa, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(saved)[0],
                               jax.tree_util.tree_flatten_with_path(now)[0]):
        assert np.array_equal(a, b), pa


def test_launch_train_on_cpu_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: 4 steps with a
    checkpoint every 2 and microbatches + compression; a second call with
    --steps 6 resumes at step 4."""
    from repro_torch.launch import train

    args = ["--arch", "gemma3-1b", "--device", "cpu", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--microbatches", "2", "--grad-compress"]
    state, report = train.main(args + ["--steps", "4"])
    assert report.steps_run == 4 and int(state.opt.step) == 4
    assert all(np.isfinite(report.losses))
    state, report = train.main(args + ["--steps", "6"])
    assert report.steps_run == 2 and int(state.opt.step) == 6


@pytest.mark.parametrize("arch,layers", [
    pytest.param(a, n, id=a) for a, n in (("olmoe-1b-7b", 1),
                                         ("mamba2-780m", 1),
                                         ("recurrentgemma-9b", 3),
                                         ("llama-3.2-vision-11b", 5))])
def test_launch_train_moe_ssd_on_cpu(arch, layers, tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` for the MoE,
    SSD, RG-LRU and vlm families (the vlm's ``data.synthetic`` batches
    carry ``cross_embeds``): 2 steps and a checkpoint, then ``--layers``
    cut to one super-block (the depth cut; one layer where the pattern is
    one layer) for 2 fresh steps; finite losses."""
    from repro_torch.launch import train

    args = ["--arch", arch, "--device", "cpu", "--seq", "32",
            "--ckpt-every", "2", "--steps", "2"]
    state, report = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert report.steps_run == 2 and all(np.isfinite(report.losses))
    state, report = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                       "--layers", str(layers)])
    assert report.steps_run == 2 and all(np.isfinite(report.losses))
    assert set(state.params["blocks"]["pos0"]) >= {"ln1"}
    assert T.leaves(state.params["blocks"])[0].shape[0] == 1
    assert "rem" not in state.params
