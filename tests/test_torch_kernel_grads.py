"""The backward passes of the port's kernels (K4, K5, K6) on the CPU.

Each plain backward of ``repro_torch.kernels.ref`` against ``torch.autograd``
through its plain forward and against ``jax.grad`` through what the JAX
package's training differentiates (``_attention_scores``, a take and a
masked sum, a gather and a segment sum), on ``tests/library_cases.py``'s
numpy-made backward cases (causal, windows, GQA, MLA's (192, 128), rows that
see no key, repeated ids, padding, empty ELL rows); each autograd Function
of ``kernels.ops`` running its plain backward on the CPU, counted, with no
launch; the Functions' refusals.  Tolerances: 1e-5 of the gradient's
largest |value| between the plain backward and autograd (float32, the same
arithmetic in another order), 1e-4 against JAX (float32 products in other
orders over up to 257 rows).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from library_cases import (ATTENTION_BWD_CASES, BAG_BWD_CASES, SPMM_BWD_CASES,
                           attention_rows_seeing_a_key, case_id, make_attention_bwd_case,
                           make_bag_bwd_case, make_spmm_bwd_case)
from repro.models.transformer import _attention_scores
from repro_torch.kernels import ops, ref

TORCH_TOL = 1e-5
JAX_TOL = 1e-4


def _close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    scale = max(float(np.abs(exp).max()) if exp.size else 0.0, 1e-30)
    err = float(np.abs(got - exp).max()) if exp.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_attention_bwd_ref_matches_autograd_and_jax(case, rng):
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, do = make_attention_bwd_case(rng, *case)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    auto = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                      _t(do), causal=causal, window=window)
    for name, g, a in zip(("dq", "dk", "dv"), got, auto):
        _close(g.numpy(), a.numpy(), TORCH_TOL, name)
    seen = attention_rows_seeing_a_key(S, T, causal, window)
    assert not got[0][:, :, ~seen].any()   # no key, no gradient

    def f(q_, k_, v_):
        o = _attention_scores(q_, k_, v_, causal=causal, window=window, t_total=T)
        return jnp.sum(o * do)

    jq, jk, jv = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # JAX masks with -1e30, so a row that sees no key attends to every key
    # evenly there: only the rows that see one compare, and dk, dv only when
    # every row does
    _close(got[0].numpy()[:, :, seen], np.asarray(jq)[:, :, seen], JAX_TOL, "dq vs jax")
    if seen.all():
        _close(got[1].numpy(), np.asarray(jk), JAX_TOL, "dk vs jax")
        _close(got[2].numpy(), np.asarray(jv), JAX_TOL, "dv vs jax")


@pytest.mark.parametrize("case", BAG_BWD_CASES, ids=case_id)
def test_embedding_bag_bwd_ref_matches_autograd_and_jax(case, rng):
    V, D, B, bag, edge = case
    idx, dout = make_bag_bwd_case(rng, *case)
    table = rng.standard_normal((V, D)).astype(np.float32)
    tt = _t(table, True)
    (auto,) = torch.autograd.grad(ref.embedding_bag_ref(tt, _t(idx)), tt, _t(dout))
    got = ref.embedding_bag_bwd_ref(_t(idx), _t(dout), V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    _close(got.numpy(), auto.numpy(), TORCH_TOL, "vs autograd")

    def f(tab):
        rows = jnp.take(tab, jnp.where(idx >= 0, idx, 0), axis=0)
        return jnp.sum(jnp.where((idx >= 0)[..., None], rows, 0.0).sum(axis=1) * dout)

    _close(got.numpy(), np.asarray(jax.grad(f)(jnp.asarray(table))), JAX_TOL, "vs jax")
    if edge == "repeat":   # ids 0-4 only: every other row of the table gets nothing
        assert not got[5:].any() and got[:5].abs().sum() > 0


@pytest.mark.parametrize("case", SPMM_BWD_CASES, ids=case_id)
def test_ell_spmm_bwd_is_the_transposed_spmm(case, rng):
    """dx of ``ops.ell_spmm`` is K5 over the transposed rows: against
    autograd through the plain forward and jax.grad through a gather and a
    segment sum over the same edges."""
    n, m, F, edge = case
    nbr, wgt, nbr_t, wgt_t, x, dout = make_spmm_bwd_case(rng, *case)
    tx = _t(x, True)
    out = ops.ell_spmm(_t(nbr), _t(wgt), tx, _t(nbr_t), _t(wgt_t))
    (got,) = torch.autograd.grad(out, tx, _t(dout))
    tx2 = _t(x, True)
    (auto,) = torch.autograd.grad(ref.ell_spmm_ref(_t(nbr), _t(wgt), tx2), tx2, _t(dout))
    _close(got.numpy(), auto.numpy(), TORCH_TOL, "vs autograd")
    _close(got.numpy(), ref.ell_spmm_ref(_t(nbr_t), _t(wgt_t), _t(dout)).numpy(), 0.0,
           "the transposed spmm")
    dst, slot = np.nonzero(nbr >= 0)
    src, w = nbr[dst, slot], wgt[dst, slot]

    def f(x_):
        msg = w[:, None] * x_[src]
        return jnp.sum(jax.ops.segment_sum(msg, dst, num_segments=n) * dout)

    _close(got.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))), JAX_TOL, "vs jax")
    if edge == "empty":   # the first half of the nodes has no edge either way
        assert not got[: n // 2].any()


def test_functions_run_their_plain_backward_on_the_cpu(rng):
    """On the CPU each Function's backward is its plain backward, called once
    a backward, with no launch counted."""
    q, k, v, do = make_attention_bwd_case(rng, 1, 4, 2, 50, 50, 16, 16, True, None)
    idx, dout = make_bag_bwd_case(rng, 40, 6, 10, 3, "repeat")
    nbr, wgt, nbr_t, wgt_t, x, dx = make_spmm_bwd_case(rng, 30, 90, 5, None)
    ops.reset_launches()
    with mock.patch.object(ref, "flash_attention_bwd_ref",
                           wraps=ref.flash_attention_bwd_ref) as k4, \
            mock.patch.object(ref, "embedding_bag_bwd_ref",
                              wraps=ref.embedding_bag_bwd_ref) as k6, \
            mock.patch.object(ops, "_ell_spmm", wraps=ops._ell_spmm) as k5:
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        (ops.flash_attention(tq, tk, tv) * _t(do)).sum().backward()
        table = torch.zeros((40, 6), requires_grad=True)
        (ops.embedding_bag(table, _t(idx)) * _t(dout)).sum().backward()
        tx = _t(x, True)
        (ops.ell_spmm(_t(nbr), _t(wgt), tx, _t(nbr_t), _t(wgt_t)) * _t(dx)).sum().backward()
    assert k4.call_count == 1 and k6.call_count == 1
    assert [c.args[3:] for c in k5.call_args_list] == [(), ("ell_spmm_bwd",)]
    assert tq.grad is not None and table.grad is not None and tx.grad is not None
    assert not any(ops.LAUNCHES.values())


def test_backward_refusals(rng):
    """A K5 weight that requires grad, a transposed pair that does not fit,
    a K5 backward without it, and a K4 backward over a kv_len prefix raise;
    so do backward inputs of the wrong shape."""
    nbr, wgt, nbr_t, wgt_t, x, _ = make_spmm_bwd_case(rng, 30, 90, 5, None)
    nbr, wgt, nbr_t, wgt_t = _t(nbr), _t(wgt), _t(nbr_t), _t(wgt_t)
    with pytest.raises(ValueError, match="fixed coefficients"):
        ops.ell_spmm(nbr, wgt.clone().requires_grad_(True), _t(x))
    with pytest.raises(ValueError, match="n_src"):
        ops.ell_spmm(nbr, wgt, _t(x), nbr_t[:5].contiguous(), wgt_t[:5].contiguous())
    with pytest.raises(ValueError, match="both"):
        ops.ell_spmm(nbr, wgt, _t(x), nbr_t)
    with pytest.raises(ValueError, match="transposed"):
        ops.ell_spmm(nbr, wgt, _t(x, True)).sum().backward()
    q, k, v, do = (_t(a, True) for a in make_attention_bwd_case(rng, 1, 2, 2, 4, 40, 8, 8,
                                                                True, None))
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, k, v, kv_len=20).sum().backward()
    with pytest.raises(ValueError, match="do must be"):
        ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(), q.detach(),
                                do.detach()[:, :, :2].contiguous())
    with pytest.raises(ValueError, match="bags"):
        ops.embedding_bag_bwd(torch.zeros((3, 2), dtype=torch.int32), torch.zeros((4, 5)), 9)
