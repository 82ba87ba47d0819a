"""The streaming-softmax attention's block buffers (``layers._Flash``).

Its forward and backward overwrite each key chunk's blocks in place. They
are held here, bit for bit (``torch.equal``), to a frozen copy of the
out-of-place code they replace (``_oracle_fwd`` / ``_OracleFlash``):
float32 and bfloat16, no window and a window whose first key chunks are
fully masked in the later rows (a LOCAL layer's warm-up), S = 4 chunks,
grouped heads (G = 2 over 2 kv heads) and one kv head. Against the JAX
package: ``tests/test_torch_lm_train.py`` (``jax.vjp`` of ``_flash_fn``);
the flash path against the dense one: ``tests/test_torch_lm_layers.py``.

The buffers themselves: one ``_Flash`` forward and backward traced by the
``Recorder`` on meta tensors holds at most two float32 blocks of [B, Hkv,
G, S, chunk] and one compute-dtype block at its peak, where the frozen
code holds six float32 ones; the forward alone holds one float32 block.

This file imports no JAX: ``chip_smoke.py`` holds the port to the same
oracle on the card.
"""
from typing import Optional

import numpy as np
import pytest
import torch

from repro_torch.models import layers
from repro_torch.models.layers import _chunk_mask, acc_dtype
from repro_torch.roofline.counts import Recorder

B, CHUNK, D = 2, 8, 16
S = 4 * CHUNK


# -- the frozen oracle: the out-of-place code before the in-place rewrite --


def _oracle_fwd(q, k, v, window: Optional[int], chunk: int):
    cd = q.dtype
    dev = q.device
    B, S, hq, D = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, S, hkv, g, D)
    f = acc_dtype(cd)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=f))

    m = torch.full((B, hkv, g, S), -torch.inf, dtype=f, device=dev)
    l = torch.zeros((B, hkv, g, S), dtype=f, device=dev)
    acc = torch.zeros((B, hkv, g, S, D), dtype=f, device=dev)
    for j in range(S // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kj).to(f)
        s = s * scale
        ok = _chunk_mask(S, j, chunk, window, dev)
        s = torch.where(ok, s, -torch.inf)

        m_new = torch.maximum(m, s.amax(dim=-1))
        live = ~torch.isinf(m_new)
        p = torch.where(live[..., None], torch.exp(s - m_new[..., None]), 0.0)
        r = torch.where(live & ~torch.isinf(m), torch.exp(m - m_new), 0.0)
        l = l * r + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(cd), vj)
        acc = acc * r[..., None] + pv.to(f)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, hq, D)
    return out.to(cd), lse


class _OracleFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, window: Optional[int], chunk: int):
        out, lse = _oracle_fwd(q, k, v, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        window, chunk = ctx.window, ctx.chunk
        cd = q.dtype
        dev = q.device
        B, S, hq, D = q.shape
        hkv = k.shape[2]
        g = hq // hkv
        f = acc_dtype(cd)
        scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=f))
        qg = q.reshape(B, S, hkv, g, D)
        dog = do.reshape(B, S, hkv, g, D)
        og = out.reshape(B, S, hkv, g, D)
        Drow = torch.einsum("bskgd,bskgd->bkgs", dog.to(f), og.to(f))

        dq = torch.zeros((B, S, hkv, g, D), dtype=f, device=dev)
        dks, dvs = [], []
        for j in range(S // chunk):
            kj = k[:, j * chunk:(j + 1) * chunk]
            vj = v[:, j * chunk:(j + 1) * chunk]
            s = torch.einsum("bskgd,btkd->bkgst", qg, kj).to(f)
            s = s * scale
            ok = _chunk_mask(S, j, chunk, window, dev)
            p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
            dvs.append(torch.einsum("bkgst,bskgd->btkd", p.to(cd), dog))
            dp = torch.einsum("bskgd,btkd->bkgst", dog, vj).to(f)
            ds = p * (dp - Drow[..., None]) * scale
            dq = dq + torch.einsum("bkgst,btkd->bskgd", ds.to(cd), kj).to(f)
            dks.append(torch.einsum("bkgst,bskgd->btkd", ds.to(cd), qg))
        dk = torch.cat(dks, dim=1)
        dv = torch.cat(dvs, dim=1)
        return (dq.to(cd).reshape(B, S, hq, D), dk.to(cd), dv.to(cd), None,
                None)


def flash_and_oracle(q, k, v, do, window: Optional[int], chunk: int):
    """(out, dq, dk, dv) of ``layers._Flash`` and of the oracle on the same
    inputs (each run on its own leaf copies)."""
    res = []
    for fn in (layers._Flash, _OracleFlash):
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn.apply(*xs, window, chunk)
        res.append((out.detach(),
                    *torch.autograd.grad(out, xs, do)))
    return res


def _inputs(seed: int, hq: int, hkv: int, dtype):
    rng = np.random.default_rng(seed)
    q, do = (torch.tensor(rng.standard_normal((B, S, hq, D)), dtype=dtype)
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, S, hkv, D)), dtype=dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["G2", "hkv1"])
@pytest.mark.parametrize("window", [None, 5], ids=["global", "window5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_is_bitwise_the_out_of_place_code(dtype, window, heads):
    """Window 5 at chunk 8: from row 12 on, a row's first chunk is fully
    masked (from row 20, its first two), so ``live`` guards them."""
    q, k, v, do = _inputs(0, *heads, dtype)
    got, want = flash_and_oracle(q, k, v, do, window, CHUNK)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert torch.equal(g, w), (name, float((g - w).abs().max()))


def _peak_blocks(fn, dtype, backward: bool = True):
    """One forward (and backward) of ``fn`` on meta tensors (B = 2, S =
    2048, 4 heads over 2 kv heads, chunk 512) under the ``Recorder``: the
    number of float32 and of ``dtype`` storages the size of one [B, Hkv,
    G, S, chunk] block among those live at its peak."""
    Bm, Sm, chunk = 2, 2048, 512
    xs = [torch.empty((Bm, Sm, h, 64), dtype=dtype, device="meta")
          .requires_grad_(backward) for h in (4, 2, 2)]
    do = torch.empty((Bm, Sm, 4, 64), dtype=dtype, device="meta")
    rec = Recorder()
    rec.exclude(xs + [do])
    with rec:
        out = fn.apply(*xs, None, chunk)
        if backward:
            grads = torch.autograd.grad(out, xs, do)
            del grads
        del out
    numel = Bm * 4 * Sm * chunk
    live = rec.counts().peak_live
    return tuple(sum(1 for b, _, _, dt in live
                     if dt == str(t) and b == numel * t.itemsize)
                 for t in (torch.float32, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_holds_two_float32_blocks(dtype):
    f32, cd = _peak_blocks(layers._Flash, dtype)
    assert 1 <= f32 <= 2, f32
    if dtype != torch.float32:
        assert cd <= 1, cd
    # the frozen code held six at once
    assert _peak_blocks(_OracleFlash, dtype)[0] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_forward_holds_one_float32_block(dtype):
    """The forward alone (a prefill's): one float32 block and one
    compute-dtype block, each chunk's freed before the next one's scores
    are made; the frozen code held four float32 ones."""
    f32, cd = _peak_blocks(layers._Flash, dtype, backward=False)
    assert f32 == 1, f32
    if dtype != torch.float32:
        assert cd <= 1, cd
    assert _peak_blocks(_OracleFlash, dtype, backward=False)[0] == 4
