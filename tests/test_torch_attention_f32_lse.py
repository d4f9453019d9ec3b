"""K4's float32 log-sum-exp on the CPU: the forward keeps it for the float32
backward (``csrc/flash_attention_bwd.cu`` reads it and forms the logits once).

The autograd Function keeps lse for a float32 call that needs a gradient and
for none under ``torch.no_grad`` or without ``requires_grad``; on
``tests/library_cases.py``'s numpy-made backward cases the lse the Function
hands its backward is the float32 forward's, and the gradients
``ref.flash_attention_bwd_ref`` makes from it equal those it makes with the
softmax recomputed (1e-5 of the largest |value|: the same float32 arithmetic
in another order) and ``jax.grad`` through what the JAX package's training
differentiates, ``_attention_scores`` (1e-4: float32 products in other
orders over up to 512 keys); under ``torch.utils.checkpoint`` (the models'
``remat``) the recomputed forward keeps lse again and the gradients equal
the run without it, bit for bit.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from library_cases import (ATTENTION_BWD_CASES, attention_rows_seeing_a_key, case_id,
                           make_attention_bwd_case)
from repro.models.transformer import _attention_scores
from repro_torch.kernels import ops, ref

TORCH_TOL = 1e-5
JAX_TOL = 1e-4


def _close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    scale = max(float(np.abs(exp).max()) if exp.size else 0.0, 1e-30)
    err = float(np.abs(got - exp).max()) if exp.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _watched():
    """The plain forward and backward, wrapped so their calls are seen."""
    return (mock.patch.object(ref, "flash_attention_ref", wraps=ref.flash_attention_ref),
            mock.patch.object(ref, "flash_attention_bwd_ref", wraps=ref.flash_attention_bwd_ref))


@pytest.mark.parametrize("grad", ["requires_grad", "no_grad", "no_requires_grad"])
def test_f32_function_keeps_lse_for_a_gradient(rng, grad):
    """A float32 call asks its forward for lse exactly when autograd will
    call the backward: an input that requires grad, outside ``no_grad``."""
    q, k, v, _ = (torch.from_numpy(a) for a in make_attention_bwd_case(
        rng, 1, 4, 2, 40, 60, 16, 16, True, 25))
    if grad != "no_requires_grad":
        q.requires_grad_(True)
    fwd_patch, _ = _watched()
    with fwd_patch as fwd:
        if grad == "no_grad":
            with torch.no_grad():
                out = ops.flash_attention(q, k, v, window=25)
        else:
            out = ops.flash_attention(q, k, v, window=25)
    keeps = grad == "requires_grad"
    assert fwd.call_count == 1 and fwd.call_args.kwargs["return_lse"] is keeps
    assert out.requires_grad is keeps and out.dtype == torch.float32
    assert torch.equal(out.detach(), ref.flash_attention_ref(q.detach(), k, v, window=25))


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_f32_backward_from_the_forwards_lse(case, rng):
    """Through the Function: the lse handed to the backward is the float32
    forward's; the gradients from it equal the recomputed softmax's and
    ``jax.grad``'s."""
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, do = make_attention_bwd_case(rng, *case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tdo = torch.from_numpy(do)
    fwd_patch, bwd_patch = _watched()
    with fwd_patch, bwd_patch as bwd:
        out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
        (out * tdo).sum().backward()
    assert bwd.call_count == 1
    lse = bwd.call_args.kwargs["lse"]
    _, exp_lse = ref.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(), causal=causal,
                                         window=window, return_lse=True)
    assert lse is not None and torch.equal(lse, exp_lse)
    got = (tq.grad, tk.grad, tv.grad)
    whole = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                        tdo, causal=causal, window=window)
    for name, g, e in zip(("dq", "dk", "dv"), got, whole):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        _close(g.numpy(), e.numpy(), TORCH_TOL, f"{name} from the forward's lse vs recomputed")
    seen = attention_rows_seeing_a_key(S, T, causal, window)
    assert not got[0][:, :, ~seen].any()

    def f(q_, k_, v_):
        o = _attention_scores(q_, k_, v_, causal=causal, window=window, t_total=T)
        return jnp.sum(o * do)

    jq, jk, jv = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # JAX masks with -1e30: a row that sees no key attends to every key evenly
    # there, so only the rows that see one compare, and dk, dv when all do
    _close(got[0].numpy()[:, :, seen], np.asarray(jq)[:, :, seen], JAX_TOL, "dq vs jax")
    if seen.all():
        _close(got[1].numpy(), np.asarray(jk), JAX_TOL, "dk vs jax")
        _close(got[2].numpy(), np.asarray(jv), JAX_TOL, "dv vs jax")


@pytest.mark.parametrize("window", [None, 30])
def test_f32_lse_kept_again_under_checkpoint(rng, window):
    """``torch.utils.checkpoint`` (non-reentrant, as the models' ``remat``):
    the forward and its recomputation in the backward both keep lse, the
    backward reads the recomputed one, and the gradients equal those of the
    call without checkpointing, bit for bit."""
    q, k, v, do = (torch.from_numpy(a) for a in make_attention_bwd_case(
        rng, 2, 4, 2, 70, 70, 32, 32, True, window))

    def grads(remat):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        attend = lambda a, b, c: ops.flash_attention(a, b, c, window=window)  # noqa: E731
        fwd_patch, bwd_patch = _watched()
        with fwd_patch as fwd, bwd_patch as bwd:
            out = (checkpoint(attend, *leaves, use_reentrant=False, preserve_rng_state=False)
                   if remat else attend(*leaves))
            (out * do).sum().backward()
        return [t.grad for t in leaves], fwd.call_args_list, bwd.call_args_list

    plain, fwds, bwds = grads(False)
    remat, rfwds, rbwds = grads(True)
    assert [c.kwargs["return_lse"] for c in fwds] == [True]
    assert [c.kwargs["return_lse"] for c in rfwds] == [True, True]
    assert len(bwds) == len(rbwds) == 1
    assert torch.equal(rbwds[0].kwargs["lse"], bwds[0].kwargs["lse"])
    for g, e in zip(remat, plain):
        assert torch.equal(g, e)
