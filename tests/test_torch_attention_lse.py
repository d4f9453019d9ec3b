"""K4's log-sum-exp on the CPU: the interface between its bfloat16 forward
and its bfloat16 backward (``csrc/flash_attention_bwd_sm90.cu``).

On ``tests/library_cases.py``'s numpy-made backward cases (causal, windows,
GQA, MLA's (192, 128), rows that see no key, eight key tiles a dq row):
``ref.flash_attention_ref(..., return_lse=True)``'s lse against
``jax.nn.logsumexp`` of the masked, scaled logits over ln 2 (+inf for a row
with no key), its output unchanged by the flag; ``ref.flash_attention_bwd_ref``
with the forward's lse against itself without it and against ``jax.grad``
through what the JAX package's training differentiates (``_attention_scores``);
the autograd Function keeping lse only for a bfloat16 call that needs a
gradient and handing it to the backward; the backward's dispatch by dtype
and its refusals.  Tolerances: 1e-5 of the largest |value| between the plain
versions (float32, the same arithmetic in another order: exp2 of a
difference against a softmax), 1e-4 against JAX (float32 products in other
orders over up to 512 keys); lse within 1e-5 of JAX's (its values are O(10)).

At inference (a decode over a cache split along its sequence):
``ops.flash_attention(..., return_lse=True)`` is the plain version's
``(out, lse)`` on the CPU, outside autograd; the merge of the ranks'
``(out, lse)`` (``dist.split_softmax.merge``, the ranks stacked on one
process and its all-reduces over them) over the keys split into blocks, with
blocks past the position or outside the window holding no key, equals the
attention over all the keys within 1e-6 (float32), from K4's rows and from
``split_softmax.local_attention``'s alike.
"""
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from library_cases import (ATTENTION_BWD_CASES, attention_rows_seeing_a_key, case_id,
                           make_attention_bwd_case)
from repro.models.transformer import _attention_scores
from repro_torch.dist import split_softmax
from repro_torch.kernels import ops, ref

TORCH_TOL = 1e-5
JAX_TOL = 1e-4
LSE_TOL = 1e-5


def _close(got, exp, tol, what=""):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    scale = max(float(np.abs(exp).max()) if exp.size else 0.0, 1e-30)
    err = float(np.abs(got - exp).max()) if exp.size else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _mask(S, T, causal, window) -> np.ndarray:
    qpos = np.arange(S)[:, None] + (T - S)
    t = np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= t <= qpos
    if window is not None:
        mask &= t > qpos - window
    return mask


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_lse_is_jax_logsumexp_over_ln2(case, rng):
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, _ = make_attention_bwd_case(rng, *case)
    out, lse = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window,
                                       return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    assert torch.equal(out, ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                                    window=window))
    rep = Hq // Hkv
    logits = jnp.einsum("bhgsd,bhtd->bhgst", jnp.asarray(q).reshape(B, Hkv, rep, S, D),
                        jnp.asarray(k)) / math.sqrt(D)
    logits = jnp.where(jnp.asarray(_mask(S, T, causal, window)), logits, -jnp.inf)
    exp = np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(B, Hq, S) / math.log(2.0)
    seen = attention_rows_seeing_a_key(S, T, causal, window)
    got = lse.numpy()
    assert np.isposinf(got[:, :, ~seen]).all()   # no key: exp2(x - lse) = 0
    if seen.any():
        _close(got[:, :, seen], exp[:, :, seen], LSE_TOL, "lse vs jax")


@pytest.mark.parametrize("case", ATTENTION_BWD_CASES, ids=case_id)
def test_bwd_ref_from_lse_matches_recomputed_and_jax(case, rng):
    B, Hq, Hkv, S, T, D, Dv, causal, window = case
    q, k, v, do = make_attention_bwd_case(rng, *case)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                       return_lse=True)
    from_lse = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal=causal, window=window,
                                           lse=lse)
    whole = ref.flash_attention_bwd_ref(tq, tk, tv, out, tdo, causal=causal, window=window)
    for name, g, e in zip(("dq", "dk", "dv"), from_lse, whole):
        assert g.dtype == e.dtype and g.shape == e.shape, name
        _close(g.numpy(), e.numpy(), TORCH_TOL, f"{name} from lse vs recomputed")
    seen = attention_rows_seeing_a_key(S, T, causal, window)
    assert not from_lse[0][:, :, ~seen].any()

    def f(q_, k_, v_):
        o = _attention_scores(q_, k_, v_, causal=causal, window=window, t_total=T)
        return jnp.sum(o * do)

    jq, jk, jv = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # JAX masks with -1e30: a row that sees no key attends to every key evenly
    # there, so only the rows that see one compare, and dk, dv when all do
    _close(from_lse[0].numpy()[:, :, seen], np.asarray(jq)[:, :, seen], JAX_TOL, "dq vs jax")
    if seen.all():
        _close(from_lse[1].numpy(), np.asarray(jk), JAX_TOL, "dk vs jax")
        _close(from_lse[2].numpy(), np.asarray(jv), JAX_TOL, "dv vs jax")


@pytest.mark.parametrize("dtype,keeps", [(torch.bfloat16, True), (torch.float32, False)])
def test_function_keeps_lse_only_for_a_gradient(rng, dtype, keeps):
    """The autograd Function asks the forward for lse when a gradient is
    needed and its dtype's backward reads one (bfloat16), and hands it to
    the backward; without a gradient, or in float32, it asks for none."""
    q, k, v, do = (_t(a).to(dtype) for a in make_attention_bwd_case(
        rng, 1, 4, 2, 70, 90, 32, 16, True, 40))
    with mock.patch.object(ref, "flash_attention_ref", wraps=ref.flash_attention_ref) as fwd, \
            mock.patch.object(ref, "flash_attention_bwd_ref",
                              wraps=ref.flash_attention_bwd_ref) as bwd:
        out = ops.flash_attention(q, k, v, window=40)
        with torch.no_grad():
            ops.flash_attention(*(t.requires_grad_(True) for t in (q, k, v)), window=40)
        assert [c.kwargs.get("return_lse") for c in fwd.call_args_list] == [False, False]
        got = ops.flash_attention(q, k, v, window=40)
        assert fwd.call_args_list[-1].kwargs["return_lse"] is keeps
        (got.float() * do.float()).sum().backward()
    assert not out.requires_grad and bwd.call_count == 1
    lse = bwd.call_args.kwargs["lse"]
    if keeps:
        _, exp = ref.flash_attention_ref(q.detach(), k.detach(), v.detach(), window=40,
                                         return_lse=True)
        assert torch.equal(lse, exp)
    else:
        assert lse is None
    exp = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), got.detach(),
                                      do.to(dtype), window=40)
    for g, e in zip((q.grad, k.grad, v.grad), exp):
        assert g.dtype == dtype
        _close(g.float().numpy(), e.float().numpy(), 2.0 ** -7, "gradient through the Function")


def test_attention_bwd_kernels_dispatch_by_dtype(rng):
    """Each dtype has its backward kernel, bfloat16 on the tensor cores and
    float32 on the CUDA cores, beside the forward's; other dtypes and an
    lse of the wrong shape or type are refused on either device."""
    assert ops.ATTENTION_BWD_KERNELS == {torch.bfloat16: "flash_attention_bwd_sm90",
                                         torch.float32: "flash_attention_bwd"}
    assert ops.ATTENTION_BWD_KERNELS.keys() == ops.ATTENTION_KERNELS.keys()
    for dtype, name in ops.ATTENTION_BWD_KERNELS.items():
        assert ops.attention_bwd_kernel(dtype) == name and name in ops.LAUNCHES
    q, k, v, do = (_t(a) for a in make_attention_bwd_case(rng, 1, 2, 1, 20, 20, 16, 16,
                                                          True, None))
    o = ref.flash_attention_ref(q, k, v)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.attention_bwd_kernel(dtype)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.flash_attention_bwd(*(t.to(dtype) for t in (q, k, v, o, do)))
    for bad in (torch.zeros(1, 2, 19), torch.zeros(1, 2, 20, dtype=torch.float64)):
        with pytest.raises(ValueError, match="lse must be"):
            ops.flash_attention_bwd(q, k, v, o, do, lse=bad)
    ops.reset_launches()
    got = ops.flash_attention_bwd(q, k, v, o, do)
    assert all(g.dtype == torch.float32 for g in got) and not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len,window", [(None, None), (70, None), (90, 40), (33, 1)])
def test_return_lse_is_the_plain_version(rng, dtype, kv_len, window):
    """``ops.flash_attention(..., return_lse=True)`` on the CPU: the plain
    version's ``(out, lse)`` exactly, out the same as without the flag, no
    autograd even for inputs that need a gradient."""
    q, k, v, _ = (_t(a).to(dtype) for a in make_attention_bwd_case(
        rng, 2, 4, 2, 6, 90, 32, 16, True, window))
    q.requires_grad_(True)
    out, lse = ops.flash_attention(q, k, v, window=window, kv_len=kv_len, return_lse=True)
    exp_out, exp_lse = ref.flash_attention_ref(q.detach(), k, v, window=window, kv_len=kv_len,
                                               return_lse=True)
    assert not out.requires_grad and not lse.requires_grad
    assert (lse.dtype, tuple(lse.shape)) == (torch.float32, (2, 4, 6))
    assert torch.equal(out, exp_out) and torch.equal(lse, exp_lse)
    assert torch.equal(out, ops.flash_attention(q, k, v, window=window, kv_len=kv_len))


def _stacked_all_reduce(t, op):
    """The ranks stacked along dim 0 on one process: each rank's slice
    replaced by the reduction over the ranks."""
    red = t.amax(dim=0) if op == torch.distributed.ReduceOp.MAX else t.sum(dim=0)
    t.copy_(red.expand_as(t))


# (ranks, positions a rank, pos, window): every block full; blocks past pos
# empty; a window inside one block; across two; exactly one block ending at
# pos (the last position of a slice); a window of one key; odd sizes
SPLITS = [(2, 8, 15, None), (4, 8, 9, None), (4, 8, 30, 5), (4, 8, 20, 10), (4, 8, 23, 8),
          (4, 8, 24, 1), (3, 5, 14, None), (4, 16, 63, 32)]


@pytest.mark.parametrize("source", ["k4", "local"])
@pytest.mark.parametrize("ranks,block,pos,window", SPLITS)
def test_merge_of_key_blocks_is_whole_attention(rng, ranks, block, pos, window, source):
    """A decode row at ``pos`` over keys split into ``ranks`` blocks of
    ``block`` positions: each block's ``(out, lse)`` over the keys it holds
    in ``[pos - window + 1, pos]`` (K4 over its filled prefix with the
    window's count of keys, or ``local_attention`` over the kept keys; a
    block with none gives 0 and ``+inf``), merged, equals the attention over
    the filled prefix of the whole cache within 1e-6."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    T = ranks * block
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, 1, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    want = ref.flash_attention_ref(q, k, v, window=window, kv_len=pos + 1)
    lo = 0 if window is None else max(pos - window + 1, 0)
    outs, lses, kept = [], [], []
    for r in range(ranks):
        base = r * block
        n = min(max(pos + 1 - base, 0), block)
        a = min(max(lo - base, 0), n)
        kb, vb = k[:, :, base:base + block].contiguous(), v[:, :, base:base + block].contiguous()
        kept.append(n - a)
        if n == a:
            o, lse = torch.zeros(B, Hq, 1, D), torch.full((B, Hq, 1), math.inf)
        elif source == "k4":
            o, lse = ops.flash_attention(q, kb, vb, window=n - a, kv_len=n, return_lse=True)
        else:
            logits = torch.einsum("bkrsd,bktd->bkrst", q.reshape(B, Hkv, 2, 1, D),
                                  kb[:, :, a:n]) / math.sqrt(D)
            o, lse = split_softmax.local_attention(logits, vb[:, :, None, a:n])
            o, lse = o.reshape(B, Hq, 1, D), lse.reshape(B, Hq, 1)
        outs.append(o)
        lses.append(lse)
    assert sum(kept) == pos + 1 - lo
    got = split_softmax.merge(torch.stack(outs), torch.stack(lses), _stacked_all_reduce)
    for r in range(ranks):
        _close(got[r].numpy(), want.numpy(), 1e-6, f"rank {r}")
    if 0 in kept:   # the control: an empty block weighted as if it held keys
        bad = split_softmax.merge(torch.stack(outs), torch.stack(lses).nan_to_num(posinf=0.0),
                                  _stacked_all_reduce)
        with pytest.raises(AssertionError):
            _close(bad[0].numpy(), want.numpy(), 1e-6)
