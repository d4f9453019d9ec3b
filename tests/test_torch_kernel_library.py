"""K3-K6, the kernel library: the port's plain versions against ``repro``'s.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run the kernels'
plain versions, so these tests hold the plain versions and the wrappers'
checks against the JAX package on the same numpy inputs:

  * K3 ``bitset_mm`` against the Pallas kernel in interpret mode, exactly
    (the words are bit patterns), and its closure fixpoint against
    ``repro.graph.reach.transitive_closure_bits``;
  * K4 ``flash_attention`` against the Pallas kernel in interpret mode, at
    the JAX package's own tolerances (2e-5 in float32, 0.05 in bfloat16),
    on shapes that include the tile edges of the card's bfloat16 kernel and
    of its float32 tiled kernel (``tests/library_cases.py``), and the choice
    of its kernel by dtype; with a value width of its own (MLA's prefill,
    D = 192 and Dv = 128) against ``repro.models.transformer
    ._attention_scores``, the function MLA calls in the JAX package (its
    Pallas kernel ties v's width to D);
  * K5 ``ell_spmm`` and K6 ``embedding_bag`` against the jnp references at
    1e-5, K6 also on the edges of its card kernel (``tests/library_cases.py``):
    their Pallas kernels do not run under the installed JAX (``pl.load``
    is gone), so the references are what the JAX package can still run.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.generators import paper_dataset_analogue as jax_analogue
from repro.graph.generators import random_dag as jax_random_dag
from repro.graph.reach import transitive_closure_bits
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from library_cases import (ATTENTION_DV_CASES, ATTENTION_F32_CASES, BAG_CASES, case_id,
                           make_bag_case, make_kv_len_case, padding_rows)
from repro.models.transformer import _attention_scores
from repro_torch.graph.generators import paper_dataset_analogue, random_dag
from repro_torch.graph.reach import adjacency_bits
from repro_torch.kernels import ops, ref


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x: np.ndarray) -> torch.Tensor:
    """uint32 words as the port keeps them: int32 bit patterns."""
    return _t(x.view(np.int32))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("n,k,m", [(16, 32, 32), (70, 90, 100), (128, 256, 64)])
def test_bitset_mm_matches_pallas_interpret(n, k, m, rng):
    wk, wm = (k + 31) // 32, (m + 31) // 32
    A = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
    X = rng.integers(0, 2**32, size=(k, wm), dtype=np.uint32)
    exp = np.asarray(jops.bitset_mm(jnp.asarray(A), jnp.asarray(X), block_n=16, block_k=32,
                                    block_w=8, interpret=True))
    got = ops.bitset_mm(_bits(A), _bits(X))
    assert got.dtype == torch.int32 and got.shape == (n, wm)
    assert (_words(got) == exp).all()
    assert (_words(ref.bitset_mm_ref(_bits(A), _bits(X))) == exp).all()


def test_bitset_mm_edges(rng):
    """Bits at or beyond k never reach the output (k = 90: every bit of the
    last word set); bit 31 of a word is a column like any other; a row or a
    whole matrix with no bit set gives zeros; n = 1; the last column k - 1."""
    k, wm = 90, 3
    X = rng.integers(0, 2**32, size=(k, wm), dtype=np.uint32)
    A = np.zeros((4, 3), np.uint32)
    A[0, 2] = 0xFFFFFFFF                      # columns 64..89 and 26 bits past k
    A[1, 0] = np.uint32(1) << np.uint32(31)   # column 31 only
    A[2, 2] = np.uint32(1) << np.uint32(25)   # the last column, k - 1 = 89
    got = _words(ops.bitset_mm(_bits(A), _bits(X)))
    np.testing.assert_array_equal(got[0], np.bitwise_or.reduce(X[64:90], axis=0))
    np.testing.assert_array_equal(got[1], X[31])
    np.testing.assert_array_equal(got[2], X[89])
    assert not got[3].any()
    assert not _words(ops.bitset_mm(_bits(np.zeros((5, 3), np.uint32)), _bits(X))).any()
    one = _words(ops.bitset_mm(_bits(A[:1]), _bits(X)))
    np.testing.assert_array_equal(one, got[:1])
    exp = np.asarray(jops.bitset_mm(jnp.asarray(A), jnp.asarray(X), block_n=16, block_k=32,
                                    block_w=8, interpret=True))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("graph", ["random_dag_64_160", "reactome"])
def test_adjacency_bits_hold_exactly_the_edges(graph):
    """Bit j of row i is set iff the edge i -> j exists."""
    g = (paper_dataset_analogue("reactome", 1.0) if graph == "reactome"
         else random_dag(64, 160, seed=0))
    A = adjacency_bits(g)
    assert A.dtype == np.uint32 and A.shape == (g.n, (g.n + 31) // 32)
    dense = np.zeros((g.n, g.n), dtype=bool)
    src, dst = g.edges()
    dense[src, dst] = True
    np.testing.assert_array_equal(ref.unpack_bits(_bits(A), g.n).numpy().astype(bool), dense)


@pytest.mark.parametrize("graph", ["random_dag_64_160", "reactome"])
def test_bitset_mm_closure_fixpoint(graph):
    """R <- R | bitset_mm(R, R) from the adjacency bits reaches a fixpoint
    equal to the JAX package's transitive closure, word for word."""
    if graph == "reactome":
        g, jg = paper_dataset_analogue("reactome", 1.0), jax_analogue("reactome", 1.0)
    else:
        g, jg = random_dag(64, 160, seed=0), jax_random_dag(64, 160, seed=0)
    R = _bits(adjacency_bits(g))
    for _ in range(g.n.bit_length() + 2):
        new = R | ops.bitset_mm(R, R)
        if torch.equal(new, R):
            break
        R = new
    else:
        pytest.fail("no fixpoint")
    np.testing.assert_array_equal(_words(R), transitive_closure_bits(jg))


# ------------------------------------------------------------------ K4


def _qkv(rng, B, Hq, Hkv, S, T, D):
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,T,D,causal,window",
    [
        (1, 2, 2, 128, 128, 32, True, None),
        (2, 4, 2, 256, 256, 64, True, None),      # GQA
        (1, 4, 1, 128, 128, 64, True, 48),        # MQA + SWA
        (2, 2, 2, 1, 256, 32, True, None),        # decode
        (1, 2, 2, 128, 256, 32, True, None),      # chunked prefill (S < T)
        (1, 2, 2, 128, 128, 32, False, None),     # bidirectional
        (1, 2, 1, 192, 64, 32, True, None),       # S > T: the first 128 rows see no key
        (1, 4, 2, 128, 128, 80, True, 40),        # D = 80 (h2o-danube) + SWA
        (1, 2, 2, 64, 128, 16, False, 24),        # a window without causal
        # the tile edges of the card's bfloat16 kernel (64 packed query rows,
        # 64 keys; D padded to 16, 32, 64, 80, 96 or 128)
        (1, 4, 4, 100, 100, 64, True, None),      # rep 1, ragged S and T
        (1, 2, 2, 130, 130, 32, True, 63),        # window one key inside a tile
        (1, 2, 2, 130, 130, 32, True, 65),        # window one key past a tile boundary
        (1, 8, 1, 33, 129, 8, True, None),        # rep 8, D = 8, T one past a tile
        (1, 4, 2, 70, 127, 24, False, 33),        # D = 24, T one short of a tile
        (1, 2, 1, 40, 90, 72, True, None),        # D = 72
        (2, 8, 2, 1, 777, 40, True, None),        # decode, ragged last key tile
    ],
)
def test_flash_attention_matches_pallas_interpret(B, Hq, Hkv, S, T, D, causal, window, rng):
    q, k, v = _qkv(rng, B, Hq, Hkv, S, T, D)
    # the Pallas kernel tiles T evenly: a ragged T takes one key block
    exp = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, block_q=64,
                                          block_k=64 if T % 64 == 0 else T, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, D)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)
    if causal and S > T:
        assert not got[:, :, : S - T].any()   # qpos < 0: no key, zero rows


@pytest.mark.parametrize("case", ATTENTION_F32_CASES, ids=case_id)
def test_flash_attention_f32_edges_match_pallas_interpret(case, rng):
    """The float32 cases at the card's tiled kernel's edges
    (``tests/library_cases.py``): the plain version against the Pallas kernel
    in interpret mode at 2e-5."""
    B, Hq, Hkv, S, T, D, causal, window = case
    q, k, v = _qkv(rng, B, Hq, Hkv, S, T, D)
    exp = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, block_q=64,
                                          block_k=64 if T % 64 == 0 else T, interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, D)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)
    if window == 0:
        assert not got.any()


@pytest.mark.parametrize("case", ATTENTION_DV_CASES, ids=case_id)
def test_flash_attention_value_width_matches_jax_attention_scores(case, rng):
    """K4 with v narrower than q and k (``tests/library_cases.py``'s
    ``ATTENTION_DV_CASES``): the plain version against JAX's naive
    ``_attention_scores`` over the filled prefix (``t_total = kv_len``), at
    2e-5; the keys past kv_len are NaN and never read; scale 1/sqrt(D)."""
    B, Hq, Hkv, S, T, kv_len, D, Dv, causal, window = case
    L = kv_len or T
    q, k, v = make_kv_len_case(rng, B, Hq, Hkv, S, T, L, D, Dv)
    exp = np.asarray(_attention_scores(jnp.asarray(q), jnp.asarray(k[:, :, :L]),
                                       jnp.asarray(v[:, :, :L]), causal=causal, window=window,
                                       t_total=L, impl="naive"))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window, kv_len=kv_len)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S, Dv) == exp.shape
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    """bfloat16 inputs: the port's output (float32 math, rounded to bfloat16)
    against the Pallas kernel on the same bfloat16 inputs and against the
    float32 reference, at the JAX package's bfloat16 tolerance."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 2, 2, 128, 128, 64)
    qb, kb, vb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    pallas = np.asarray(jops.flash_attention(qb, kb, vb, causal=True, interpret=True)
                        .astype(jnp.float32))
    f32 = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True))
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got.float().numpy(), f32, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "flash_attention_sm90"),
                                          (torch.float32, "flash_attention"),
                                          (torch.float16, None), (torch.float64, None),
                                          (torch.int32, None)])
def test_attention_kernel_is_chosen_by_dtype(dtype, kernel):
    """bfloat16 goes to the tensor-core kernel, float32 to the CUDA-core one
    (each with its own launch count and build entry); any other dtype is
    refused, not sent to either."""
    from repro_torch.kernels import build

    if kernel is None:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ops.attention_kernel(dtype)
    else:
        assert ops.attention_kernel(dtype) == kernel
        assert kernel in ops.LAUNCHES and kernel in build.SIGNATURES


def test_flash_attention_empty_rows_give_zero_where_the_jnp_reference_gives_nan(rng):
    """A window of 0 leaves no key for any row: the kernel's semantics give 0,
    ``repro.kernels.ref.flash_attention_ref`` NaN (softmax over nothing)."""
    q, k, v = _qkv(rng, 1, 2, 1, 8, 8, 16)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=0)
    assert not got.any()
    jnp_ref = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), causal=True, window=0))
    assert np.isnan(jnp_ref).all()


# K4 with kv_len: (B, Hq, Hkv, T, D, pos, window), a decode step at position
# pos over a preallocated cache of T (kv_len = pos + 1); the window cuts where
# it is under pos + 1, as JAX's decode slices its cache
KV_LEN_CASES = [(2, 4, 2, 100, 16, 0, None), (2, 4, 2, 100, 16, 37, None),
                (2, 4, 2, 100, 16, 99, None), (1, 8, 2, 130, 32, 64, None),
                (2, 4, 2, 100, 16, 70, 32), (2, 4, 2, 100, 16, 20, 32),
                (1, 4, 4, 200, 64, 150, 64), (1, 8, 2, 96, 80, 95, 40),
                (1, 4, 2, 64, 16, 63, 64), (1, 4, 2, 70, 16, 69, 100)]


def _jax_decode_attention(q, k, v, pos, window):
    """JAX's decode attention over the whole cache (``repro.models.transformer
    ._decode_layer``): a window under the cache length takes its
    ``window``-long slice, else the whole cache masked to keys <= pos."""
    from repro.models import transformer as jtf

    T = k.shape[2]
    q, k, v = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if window is not None and window < T:
        start = max(pos - window + 1, 0)
        kw = k[:, :, start:start + window]
        vw = v[:, :, start:start + window]
        return np.asarray(jtf._masked_decode_attn(q, kw, vw, jnp.arange(window) <= pos - start))
    return np.asarray(jtf._masked_decode_attn(q, k, v, jnp.arange(T) <= pos))


@pytest.mark.parametrize("case", KV_LEN_CASES, ids=case_id)
def test_flash_attention_kv_len_matches_jax_masked_decode(case, rng):
    """K4's plain version with ``kv_len = pos + 1`` over a whole cache: JAX's
    masked decode attention over the whole masked cache, within 2e-5, and
    exactly itself on the contiguous prefix; the keys past kv_len are never
    read (NaN there changes nothing)."""
    B, Hq, Hkv, T, D, pos, window = case
    q, k, v = _qkv(rng, B, Hq, Hkv, 1, T, D)
    exp = _jax_decode_attention(q, k, v, pos, window)
    k[:, :, pos + 1:] = np.nan
    v[:, :, pos + 1:] = np.nan
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, kv_len=pos + 1)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)
    prefix = ops.flash_attention(_t(q), _t(k[:, :, :pos + 1]), _t(v[:, :, :pos + 1]),
                                 causal=True, window=window)
    assert torch.equal(got, prefix)


def test_flash_attention_kv_len_right_aligns_the_queries(rng):
    """S > 1 queries with kv_len: the last query sits at key kv_len - 1, as
    attention over the contiguous prefix has it (chunked prefill)."""
    q, k, v = _qkv(rng, 1, 4, 2, 5, 64, 16)
    for kv_len, window in ((9, None), (40, 7), (64, None), (3, None)):
        got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, kv_len=kv_len)
        exp = ops.flash_attention(_t(q), _t(k[:, :, :kv_len]), _t(v[:, :, :kv_len]),
                                  causal=True, window=window)
        assert torch.equal(got, exp)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(_t(q), _t(k), _t(v), kv_len=0)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(_t(q), _t(k), _t(v), kv_len=65)


# ------------------------------------------------------------------ K5


def _ell(rng, n, d, ns, F):
    nbr = rng.integers(0, ns, size=(n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    return (nbr, rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((ns, F)).astype(np.float32))


@pytest.mark.parametrize("n,d,ns,F", [(32, 4, 50, 8), (96, 7, 200, 32), (64, 1, 64, 128)])
def test_ell_spmm_matches_jax_reference(n, d, ns, F, rng):
    nbr, wgt, x = _ell(rng, n, d, ns, F)
    exp = np.asarray(jref.ell_spmm_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(x)))
    got = ops.ell_spmm(_t(nbr), _t(wgt), _t(x))
    assert got.dtype == torch.float32 and got.shape == (n, F)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


def test_ell_spmm_padding_is_minus_one_only(rng):
    """-1 is padding (all-padding rows give 0, the last id n_src - 1 is read);
    any other id outside [0, n_src) raises."""
    nbr, wgt, x = _ell(rng, 16, 5, 40, 12)
    nbr[:4] = -1
    nbr[4:8, 0] = 39
    exp = np.asarray(jref.ell_spmm_ref(jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(x)))
    got = ops.ell_spmm(_t(nbr), _t(wgt), _t(x)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    assert not got[:4].any()
    for bad in (-2, 40, np.iinfo(np.int32).min):
        nb = nbr.copy()
        nb[9, 2] = bad
        with pytest.raises(ValueError, match="outside"):
            ops.ell_spmm(_t(nb), _t(wgt), _t(x))


def test_flash_attention_refuses_misaligned_kv(rng):
    """k and v must start 16-byte aligned (the kernel's loads); a contiguous
    view one element into its storage raises on the CPU as on the card."""
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 2, 8, 8, 16))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (a.to(dtype) for a in (q, k, v))
        buf = torch.empty(kd.numel() + 1, dtype=dtype)
        shifted = buf[1:].view(kd.shape)
        shifted.copy_(kd)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(qd, shifted, vd)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(qd, kd, shifted)
        ops.flash_attention(qd, kd, vd)


# ------------------------------------------------------------------ K6


@pytest.mark.parametrize("V,D,B,bag", [(100, 8, 32, 4), (500, 16, 64, 9), (64, 32, 16, 1)])
def test_embedding_bag_matches_jax_reference(V, D, B, bag, rng):
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    idx[rng.random((B, bag)) < 0.25] = -1
    exp = np.asarray(jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                            jnp.asarray(idx >= 0)))
    got = ops.embedding_bag(_t(table), _t(idx))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


def test_embedding_bag_every_negative_id_is_padding(rng):
    """Unlike K5, any negative id is padding (-1, -7, INT32_MIN); an all-padding
    bag gives 0, the last row V - 1 is read, D = 10 (xDeepFM's width), and an
    id >= V raises."""
    V, D = 30, 10
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(12, 6)).astype(np.int32)
    idx[0] = -1
    idx[1, :3] = [-7, np.iinfo(np.int32).min, -2]
    idx[2, 0] = V - 1
    exp = np.asarray(jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                            jnp.asarray(idx >= 0)))
    got = ops.embedding_bag(_t(table), _t(idx)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    assert not got[0].any()
    bad = idx.copy()
    bad[5, 1] = V
    with pytest.raises(ValueError, match=">= V"):
        ops.embedding_bag(_t(table), _t(bad))


@pytest.mark.parametrize("case", BAG_CASES, ids=case_id)
def test_embedding_bag_edges_match_jax_reference(case, rng):
    """K6's cases at the card kernel's edges (``tests/library_cases.py``):
    the plain version against the JAX package's reference at 1e-5."""
    V, D, B, bag, edge = case
    table, idx = make_bag_case(rng, *case)
    exp = np.asarray(jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                            jnp.asarray(idx >= 0)))
    tt = _t(table)
    if edge == "unaligned":   # off 8-byte lines, as the card test moves it
        tt = torch.empty(V * D + 1)[1:].view(V, D).copy_(tt)
    got = ops.embedding_bag(tt, _t(idx))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
    assert not got[padding_rows(B, edge)].any()


# ------------------------------------------------------------------ wrappers


def test_wrappers_check_inputs_and_count_no_cpu_launch(rng):
    """Wrong dtypes, shapes and layouts raise before anything runs; the plain
    versions on the CPU count no kernel launch."""
    ops.reset_launches()
    A = _bits(rng.integers(0, 2**32, size=(4, 2), dtype=np.uint32))
    X = _bits(rng.integers(0, 2**32, size=(64, 3), dtype=np.uint32))   # k = 64: 2 words
    with pytest.raises(ValueError, match="words per row"):
        ops.bitset_mm(A, X[:16].contiguous())
    with pytest.raises(ValueError, match="int32"):
        ops.bitset_mm(A.long(), X)
    nbr, wgt, x = (_t(a) for a in _ell(rng, 8, 3, 10, 4))
    with pytest.raises(ValueError, match="must match"):
        ops.ell_spmm(nbr, wgt[:, :2].contiguous(), x)
    with pytest.raises(ValueError, match="float32"):
        ops.ell_spmm(nbr, wgt, x.double())
    with pytest.raises(ValueError, match="int32"):
        ops.embedding_bag(x, nbr.long())
    q, k, v = (_t(a) for a in _qkv(rng, 1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            v[..., :12].contiguous())
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention(q, k, v[..., :12].contiguous())      # Dv not a multiple of 8
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(), v)   # Dv > D
    wide = torch.zeros((1, 2, 4, 200))
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(wide, wide[:, :1].contiguous(), wide[:, :1, :, :128].contiguous())
    with pytest.raises(ValueError, match="value head dim"):
        ops.flash_attention(wide[..., :192].contiguous(), wide[:, :1, :, :192].contiguous(),
                            wide[:, :1, :, :136].contiguous())   # Dv past 128
    with pytest.raises(ValueError, match="differ in dtype"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, v)
    for dtype in (torch.float32, torch.bfloat16):   # q one element into its storage
        buf = torch.empty(q.numel() + 1, dtype=dtype)
        shifted = buf[1:].view(q.shape)
        shifted.copy_(q)
        with pytest.raises(ValueError, match="q must start at a 16-byte aligned"):
            ops.flash_attention(shifted, k.to(dtype), v.to(dtype))
    assert ops.flash_attention(q, k, v).data_ptr() % 16 == 0
    ops.bitset_mm(A, X)
    ops.ell_spmm(nbr, wgt, x)
    ops.embedding_bag(x, nbr)
    ops.flash_attention(q, k, v)
    assert not any(ops.LAUNCHES.values())
