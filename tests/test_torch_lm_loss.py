"""The cross-entropy of ``transformer.loss_fn`` on one block of the
vocabulary (``vocab_cross_entropy``: a plain tensor is the one block of
the code the mesh runs on each rank's block) against ``jax.grad`` of the
reference's ``loss_fn``, at the logits: each package's ``forward`` is
replaced by one that returns the given logits, so that the loss and
``d loss / d logits`` are compared directly.

Cases: float32 and bf16 logits, labels given or the next tokens, with
labels at the first and the last vocabulary id. Tolerances (PERF.md §2):
the loss within 1e-5 relative at float32 (3e-2 at bf16, where the
reference takes the logsumexp in bf16 and the port in float32), the
gradient within 1e-4 (bf16: 3e-2) of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.models import transformer
from test_torch_lm_train import LOSS_TOL, TOL, TOL_BF16, _cfgs

B, S = 3, 17


def _inputs(V, labelled, seed=5):
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.standard_normal((B, S, V))).astype(np.float32)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    ids[0, 1], ids[1, -1], ids[2, 2] = 0, V - 1, V - 1
    if labelled:
        return logits, {"labels": ids, "tokens": ids}
    return logits, {"tokens": ids}


@pytest.mark.parametrize("labelled", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_logit_gradient_match_reference(dtype, labelled,
                                                 monkeypatch):
    rc, cfg = _cfgs("gemma3_1b")
    V = cfg.vocab_size
    logits, batch = _inputs(V, labelled)
    monkeypatch.setattr(RT, "forward", lambda c, p, b, num_groups=1: (
        p["logits"], jnp.float32(0.0)))
    monkeypatch.setattr(transformer, "forward", lambda c, p, b, num_groups=1:
                        (p["logits"], torch.zeros(())))

    jl = jnp.asarray(logits).astype(dtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grad = jax.value_and_grad(
        lambda p: RT.loss_fn(rc, p, jb)[0])({"logits": jl})
    ref_grad = np.asarray(ref_grad["logits"].astype(jnp.float32))

    tl = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_()
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, parts = transformer.loss_fn(cfg, {"logits": tl}, tb)
    grad, = torch.autograd.grad(loss, tl)
    assert loss.dtype == torch.float32 and grad.dtype == tl.dtype

    loss_tol = LOSS_TOL if dtype == "float32" else TOL_BF16
    tol = TOL if dtype == "float32" else TOL_BF16
    err = abs(float(loss.detach()) - float(ref_loss)) / abs(float(ref_loss))
    assert err <= loss_tol, f"loss {err:.2e}"
    assert float(parts["ce"].detach()) == float(loss.detach())
    g = grad.float().numpy()
    gerr = np.abs(g - ref_grad).max() / np.abs(ref_grad).max()
    assert gerr <= tol, f"d loss / d logits {gerr:.2e}"
    # the gold columns of the first and last ids carry the -1/n term
    labels = batch.get("labels", batch["tokens"][:, 1:])
    n = labels.size
    for b, s in ((0, 1), (1, S - 1), (2, 2)):
        if not labelled:
            s -= 1
        lb = labels[b, s]
        assert lb in (0, V - 1)
        assert g[b, s, lb] < 0 and ref_grad[b, s, lb] < 0
        assert abs(g[b, s, lb] - ref_grad[b, s, lb]) <= tol / n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_block_equals_the_whole_vocabulary_formula(dtype):
    """Without a mesh the blockwise code is the plain formula bit for bit,
    in the logits' dtype (float64 logits stay float64): ``logsumexp -
    gather`` and its autograd gradient."""
    logits, batch = _inputs(512, True, seed=9)
    x = torch.tensor(logits, dtype=dtype, requires_grad=True)
    lb = torch.tensor(batch["labels"])
    got = transformer.vocab_cross_entropy(x, lb)
    assert got.dtype == dtype
    g_got, = torch.autograd.grad(got.mean(), x)
    y = torch.tensor(logits, dtype=dtype, requires_grad=True)
    want = torch.logsumexp(y, -1) - torch.gather(
        y, -1, lb[..., None].long())[..., 0]
    g_want, = torch.autograd.grad(want.mean(), y)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
