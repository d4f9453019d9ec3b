"""The port's CUDA kernels on the card, against their plain versions.

K1 (label_intersect) and K2 (its slab form frontier_or and its frontier form
frontier_expand) against their plain versions, the device wave build on the
card (through frontier_expand) against the reference build, and the
kernel library (K3 bitset_mm, K4 flash_attention, K5 ell_spmm, K6
embedding_bag) against its plain versions.

These tests need a CUDA card and the CUDA toolkit (the kernels build with
``nvcc`` on first use); they carry the ``cuda`` marker and, without a card,
skip.  The file imports nothing of the JAX package, so it runs on a machine
that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from frontier_cases import ARRAYS, CASES, ORDER, assert_same_level, make_case
from repro_torch.core.api import build_oracle
from repro_torch.graph.generators import paper_dataset_analogue
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(rng, n, L, sorted_prefix):
    m = rng.integers(0, 400, size=(n, L)).astype(np.int32)
    if sorted_prefix:
        m.sort(axis=1)
        m[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=n)[:, None]] = -1
    else:
        m[rng.random((n, L)) < 0.3] = -1
    return m


@pytest.mark.parametrize("sorted_prefix", [True, False])
@pytest.mark.parametrize("Lo,Li", [(16, 8), (128, 40)])
def test_tier_intersect_kernel_matches_plain(cuda, rng, Lo, Li, sorted_prefix):
    n = 3000
    L_out = torch.from_numpy(_rows(rng, n, Lo, sorted_prefix)).to(cuda)
    L_in = torch.from_numpy(_rows(rng, n, Li, sorted_prefix)).to(cuda)
    for B in (1, 4099):
        q = rng.integers(0, n, (B, 2)).astype(np.int32)
        q[-1] = (n - 1, n - 1)
        q = torch.from_numpy(q).to(cuda)
        for width in (8, 16, 24, 128):
            before = ops.LAUNCHES["label_intersect"]
            got = ops.tier_intersect(L_out, L_in, q, width)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["label_intersect"] == before + 1
            assert got.dtype == torch.bool and got.device.type == "cuda"
            assert torch.equal(got, ref.tier_intersect_ref(L_out, L_in, q, width))


@pytest.mark.parametrize("B,La,Lb", [(7, 8, 8), (64, 24, 16), (300, 64, 48), (1, 128, 128)])
def test_label_intersect_kernel_matches_plain(cuda, rng, B, La, Lb):
    a = torch.from_numpy(_rows(rng, B, La, False)).to(cuda)
    b = torch.from_numpy(_rows(rng, B, Lb, False)).to(cuda)
    ident = lambda k: torch.arange(k, dtype=torch.int32, device=cuda)[:, None].repeat(1, 2)  # noqa: E731
    got = ops.tier_intersect(a, b, ident(B).contiguous(), max(La, Lb))
    torch.cuda.synchronize()
    assert torch.equal(got, ref.label_intersect_ref(a, b))
    pad = torch.full((16, 8), -1, dtype=torch.int32, device=cuda)
    assert not ops.tier_intersect(pad, pad, ident(16).contiguous(), 8).any()


def test_main_path_serves_through_the_kernel(cuda):
    g = paper_dataset_analogue("citeseer", scale=0.01)
    co = build_oracle(g)
    assert co.engine.backend == "kernel"
    q = np.random.default_rng(0).integers(0, g.n, (8192, 2)).astype(np.int32)
    ops.reset_launches()
    got = co.serve(q)
    assert ops.LAUNCHES["label_intersect"] > 0
    assert (got == co.serve(q, backend="host")).all()
    assert not any(co.engine.degradation.values())


# ------------------------------------------------------------ K2 frontier_or


def _frontier_case(rng, r, d, n_src, wm, edge):
    nbr = rng.integers(0, n_src, size=(r, d)).astype(np.int32)
    nbr[rng.random((r, d)) < 0.35] = -1
    f = rng.integers(0, 2**32, size=(n_src, wm), dtype=np.uint32)
    if edge == "all_invalid":
        nbr[: max(r // 2, 1)] = -1
    elif edge == "last_id":
        nbr[:, 0] = n_src - 1
    elif edge == "bit31":
        f |= np.uint32(1 << 31)
    return nbr, f.view(np.int32)


@pytest.mark.parametrize("edge", [None, "all_invalid", "last_id", "bit31"])
@pytest.mark.parametrize("r,d,n_src,wm", [(13, 4, 50, 1), (128, 16, 200, 2), (1, 7, 9, 3),
                                          (1, 16, 40, 8), (5000, 16, 9000, 8)])
def test_frontier_or_kernel_matches_plain(cuda, rng, r, d, n_src, wm, edge):
    nbr_np, f_np = _frontier_case(rng, r, d, n_src, wm, edge)
    nbr, f = torch.from_numpy(nbr_np).to(cuda), torch.from_numpy(f_np).to(cuda)
    before = ops.LAUNCHES["frontier_or"]
    got = ops.frontier_or(nbr, f)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["frontier_or"] == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, ref.frontier_or_ref(nbr, f))
    # the fused form: OR into permuted rows of a running output, with flags
    n_out = r + 7
    perm = torch.from_numpy(rng.permutation(n_out)[:r].astype(np.int64)).to(cuda)
    out0 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n_out, wm),
                                         dtype=np.int64).astype(np.int32)).to(cuda)
    outs, flags = [], []
    for fn in (ops.frontier_or, ref.frontier_or_ref):
        out, fl = out0.clone(), torch.zeros(2, dtype=torch.int32, device=cuda)
        fn(nbr, f, out=out, perm=perm, flags=fl)
        outs.append(out)
        flags.append(fl)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(flags[0], flags[1])


def test_frontier_or_kernel_refuses_bad_ids(cuda):
    f = torch.zeros((6, 2), dtype=torch.int32, device=cuda)
    for bad in (6, -2):
        nbr = torch.tensor([[0, bad]], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="outside"):
            ops.frontier_or(nbr, f)


# ------------------------------------------------ K2 frontier_expand


@pytest.mark.parametrize("name", CASES)
def test_frontier_expand_kernel_matches_plain(cuda, name):
    """The kernel against its plain version on one level's edge cases
    (tests/frontier_cases.py): words, stamps and counts exactly, the ring's
    and the cone's new entries as sets."""
    case = make_case(np.random.default_rng(CASES.index(name)), name)
    res = []
    for fn in (ops.frontier_expand, ref.frontier_expand_ref):
        t = {k: (torch.from_numpy(case[k].copy()).to(cuda) if k in ARRAYS else case[k])
             for k in ORDER}
        before = ops.LAUNCHES["frontier_expand"]
        fn(*(t[k] for k in ORDER))
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["frontier_expand"] - before
        assert launched == int(fn is ops.frontier_expand and case["hi"] > case["lo"]), name
        res.append({k: (t[k].cpu().numpy() if k in ARRAYS else t[k]) for k in ORDER})
    assert_same_level(case, res[0], res[1], name)
    assert int(res[0]["counts"][2]) == int(name.startswith("bad_")), name


def _dag_families():
    """The five construction families of tests/test_build_engine.py, made
    with the port's generators (equal graphs for equal seeds)."""
    from repro_torch.graph.csr import from_edges
    from repro_torch.graph.generators import layered_dag, random_dag, tree_dag
    from repro_torch.graph.scc import condense_to_dag

    rng = np.random.default_rng(0)
    fams = [("random_dag", random_dag(70, 200, seed=1)),
            ("layered_dag", layered_dag(80, avg_out=2.5, seed=2)),
            ("tree_dag", tree_dag(90, branching=4, seed=3))]
    src, dst = rng.integers(0, 60, 170), rng.integers(0, 60, 170)
    fams.append(("cyclic", condense_to_dag(from_edges(60, src, dst))[0]))
    src, dst = rng.integers(0, 40, 60), rng.integers(0, 40, 60)
    fams.append(("isolated", condense_to_dag(from_edges(80, src, dst))[0]))
    return fams


def _assert_same_labels(a, b, tag):
    for f in ("L_out", "L_in", "out_len", "in_len", "hop_rank"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), (tag, f)


@pytest.mark.parametrize("family", range(5))
def test_device_build_on_the_card(cuda, family):
    name, g = _dag_families()[family]
    ref_co = build_oracle(g, impl="reference")
    ops.reset_launches()
    dev_co = build_oracle(g, impl="device")
    assert ops.LAUNCHES["frontier_expand"] > 0 and ops.LAUNCHES["frontier_or"] == 0
    st = dev_co.oracle.build_stats["device"]
    assert st["device"].startswith("cuda")
    assert ops.LAUNCHES["frontier_expand"] == st["levels"]
    assert st["host_reads"] == st["levels"] + st["sweeps"]
    _assert_same_labels(ref_co.oracle, dev_co.oracle, name)
    # prune_cap (JAX's dense-prune switch) changes nothing in the frontier form
    _assert_same_labels(ref_co.oracle, build_oracle(g, impl="device", prune_cap=1).oracle,
                        f"{name} prune_cap=1")


def test_device_build_label_growth_on_the_card(cuda):
    from repro_torch.graph.generators import random_dag

    g = random_dag(60, 170, seed=7)
    ref_co = build_oracle(g, impl="reference")
    ops.reset_launches()
    dev_co = build_oracle(g, impl="device", max_wave=16, l_max=2)
    assert ops.LAUNCHES["frontier_expand"] > 0 and ops.LAUNCHES["frontier_or"] == 0
    assert dev_co.oracle.build_stats["device"]["regrows"] > 0
    _assert_same_labels(ref_co.oracle, dev_co.oracle, "l_max growth")


# ------------------------------------------------------------ kernel library


def _launched(name, fn):
    """fn() through the wrapper, which must count exactly one launch."""
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1, name
    return out


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("n,k,m", [(16, 32, 32), (70, 90, 100), (128, 256, 64), (1, 90, 8),
                                   (1024, 1024, 1024), (300, 70, 9000)])
def test_bitset_mm_kernel_matches_plain(cuda, rng, n, k, m):
    wk, wm = (k + 31) // 32, (m + 31) // 32
    a = torch.from_numpy(_u32(rng, (n, wk))).to(cuda)
    x = torch.from_numpy(_u32(rng, (k, wm))).to(cuda)
    got = _launched("bitset_mm", lambda: ops.bitset_mm(a, x))
    assert got.dtype == torch.int32 and got.shape == (n, wm)
    assert torch.equal(got, ref.bitset_mm_ref(a, x))
    # sparse rows, bit 31 in every word, rows with no bit
    sparse = torch.from_numpy(np.where(rng.random((n, wk)) < 0.2, _u32(rng, (n, wk)) | -2**31,
                                       0).astype(np.int32)).to(cuda)
    got = _launched("bitset_mm", lambda: ops.bitset_mm(sparse, x))
    assert torch.equal(got, ref.bitset_mm_ref(sparse, x))


def test_bitset_mm_kernel_closure(cuda):
    from repro_torch.graph.reach import adjacency_bits, transitive_closure_bits

    g = paper_dataset_analogue("reactome", 1.0)
    R = torch.from_numpy(adjacency_bits(g).view(np.int32)).to(cuda)
    for _ in range(g.n.bit_length() + 2):
        new = R | ops.bitset_mm(R, R)
        if torch.equal(new, R):
            break
        R = new
    assert (R.cpu().numpy().view(np.uint32) == transitive_closure_bits(g)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,T,D,causal,window",
    [
        (1, 2, 2, 128, 128, 32, True, None),
        (2, 4, 2, 256, 256, 64, True, None),
        (1, 4, 1, 128, 128, 64, True, 48),
        (2, 2, 2, 1, 256, 32, True, None),
        (1, 2, 2, 128, 256, 32, True, None),
        (1, 2, 2, 128, 128, 32, False, None),
        (1, 2, 1, 192, 64, 32, True, None),       # S > T: zero rows
        (1, 4, 2, 130, 97, 80, True, 40),          # D = 80, ragged S and T, window < S
        (1, 2, 2, 64, 100, 128, False, 24),        # window without causal, D = 128
        (3, 32, 8, 1, 1000, 64, True, None),       # decode, GQA 4
        (1, 8, 2, 1024, 1024, 64, True, None),     # kernel_bench's shape
        (1, 4, 4, 5, 300, 8, True, 0),             # window 0: no key at all
        # the bfloat16 kernel's tile edges: 64-row query tiles of rep * S packed
        # rows and 64-key tiles; S and T off the tiles, windows one key either
        # side of a tile boundary, rep 1, 4 and 8, D from 8 to 128 (padded to
        # 16, 32, 64, 80, 96 or 128), decode with a ragged last key tile, S > T
        (1, 4, 4, 100, 100, 64, True, None),       # rep 1, ragged S and T
        (1, 2, 2, 256, 256, 64, True, 63),         # window one key inside a tile
        (1, 2, 2, 256, 256, 64, True, 64),         # window on a tile boundary
        (1, 2, 2, 256, 256, 64, True, 65),         # window one key past it
        (1, 2, 2, 128, 192, 32, False, 64),        # window without causal, T > S
        (1, 8, 1, 77, 200, 64, True, None),        # rep 8
        (2, 8, 2, 33, 129, 8, True, None),         # rep 4, D = 8, T one past a tile
        (1, 4, 2, 70, 130, 24, False, 33),         # D = 24
        (1, 4, 2, 70, 127, 80, True, 65),          # D = 80, T one short of a tile
        (1, 4, 1, 50, 190, 128, True, None),       # D = 128
        (2, 32, 8, 1, 777, 64, True, None),        # decode, ragged last key tile
        (2, 32, 8, 1, 4097, 128, True, 1000),      # decode, window, D = 128
        (1, 4, 2, 150, 70, 24, True, None),        # S > T: the first 80 rows see nothing
        (1, 4, 2, 40, 20, 8, True, None),          # T under one key tile, S > T
        (1, 4, 2, 70, 100, 40, True, None),        # D = 40: columns 40-63 zero-filled
        (1, 2, 1, 64, 90, 72, False, None),        # D = 72: a 16-column second chunk
        (1, 4, 2, 64, 64, 96, True, None),         # D = 96: a 32-column second chunk
        (1, 2, 2, 65, 65, 112, True, 30),          # D = 112
    ],
)
def test_flash_attention_kernel_matches_plain(cuda, rng, B, Hq, Hkv, S, T, D, causal, window,
                                              dtype):
    q = torch.from_numpy(rng.standard_normal((B, Hq, S, D)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.standard_normal((B, Hkv, T, D)).astype(np.float32)).to(cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = _launched(ops.attention_kernel(dtype),
                    lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    assert got.dtype == dtype and got.shape == (B, Hq, S, D)
    # the plain version in float32 on the same (rounded) inputs, its result
    # rounded as the kernel's is: bfloat16 outputs may differ by one step
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                  window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)
    if causal and S > T:
        assert not got[:, :, : S - T].any()   # qpos < 0: no key, zero rows


def test_flash_attention_kernel_refuses_misaligned_kv(cuda, rng):
    """k or v one element into its storage: a ValueError before the launch
    (the kernel's 16-byte loads would fault), and the card still works."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 32)).astype(np.float32))
               .to(cuda).to(torch.bfloat16) for _ in range(3))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    shifted = buf[1:].view(k.shape)
    shifted.copy_(k)
    ops.reset_launches()
    for args in ((q, shifted, v), (q, k, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(*args)
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_sm90"] == 0
    got = _launched("flash_attention_sm90", lambda: ops.flash_attention(q, k, v))
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), exp.to(q.dtype).float(), rtol=2**-7, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_refuses_misaligned_q(cuda, rng, dtype):
    """q one element into its storage: a ValueError before either kernel
    launches (the sm90 kernel reads q 16 bytes at a time)."""
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 70, 24)).astype(np.float32))
               .to(cuda).to(dtype) for _ in range(3))
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    ops.reset_launches()
    with pytest.raises(ValueError, match="q must start at a 16-byte aligned"):
        ops.flash_attention(shifted, k, v)
    assert not any(ops.LAUNCHES.values())
    got = _launched(ops.attention_kernel(dtype), lambda: ops.flash_attention(q, k, v))
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), exp.to(dtype).float(), rtol=2**-7, atol=1e-4)


def test_flash_attention_dispatches_by_dtype(cuda, rng):
    """A bfloat16 call launches the tensor-core kernel and never the CUDA-core
    one; a float32 call the other way round."""
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 40, 64)).astype(np.float32))
               .to(cuda) for _ in range(3))
    for dtype, name, other in ((torch.bfloat16, "flash_attention_sm90", "flash_attention"),
                               (torch.float32, "flash_attention", "flash_attention_sm90")):
        ops.reset_launches()
        got = ops.flash_attention(*(t.to(dtype) for t in (q, k, v)))
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert ops.LAUNCHES[name] == 1 and ops.LAUNCHES[other] == 0, dict(ops.LAUNCHES)


@pytest.mark.parametrize("n,d,ns,F", [(32, 4, 50, 8), (96, 7, 200, 32), (64, 1, 64, 128),
                                      (4096, 16, 4096, 64), (1000, 40, 3000, 100),
                                      (7, 3, 9, 6), (1, 32, 5, 1)])
def test_ell_spmm_kernel_matches_plain(cuda, rng, n, d, ns, F):
    nbr = rng.integers(0, ns, size=(n, d)).astype(np.int32)
    nbr[rng.random((n, d)) < 0.3] = -1
    nbr[: max(n // 8, 1) // 2] = -1
    nbr[-1, 0] = ns - 1
    nbr, wgt = torch.from_numpy(nbr).to(cuda), torch.randn(n, d, device=cuda)
    x = torch.randn(ns, F, device=cuda)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5)
    # rows not 16-byte aligned: the 4-byte path
    buf = torch.empty(ns * F + 1, device=cuda)
    x1 = buf[1:].view(ns, F)
    x1.copy_(x)
    got = _launched("ell_spmm", lambda: ops.ell_spmm(nbr, wgt, x1))
    torch.testing.assert_close(got, ref.ell_spmm_ref(nbr, wgt, x), rtol=1e-5, atol=1e-5)


def test_ell_spmm_kernel_refuses_bad_ids(cuda):
    x = torch.randn(6, 8, device=cuda)
    w = torch.ones(1, 2, device=cuda)
    for bad in (6, -2):
        nbr = torch.tensor([[0, bad]], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="outside"):
            ops.ell_spmm(nbr, w, x)


@pytest.mark.parametrize("V,D,B,bag", [(100, 8, 32, 4), (500, 16, 64, 9), (64, 32, 16, 1),
                                       (100_000, 16, 8192, 8), (1000, 10, 5000, 8),
                                       (50, 3, 1, 5)])
def test_embedding_bag_kernel_matches_plain(cuda, rng, V, D, B, bag):
    idx = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    pad = rng.random((B, bag)) < 0.25
    idx[pad] = rng.integers(-2**31, 0, size=int(pad.sum()))   # any negative id pads
    idx[0] = -1
    idx[-1, -1] = V - 1
    idx, table = torch.from_numpy(idx).to(cuda), torch.randn(V, D, device=cuda)
    got = _launched("embedding_bag", lambda: ops.embedding_bag(table, idx))
    torch.testing.assert_close(got, ref.embedding_bag_ref(table, idx), rtol=1e-5, atol=1e-5)


def test_embedding_bag_kernel_refuses_bad_ids(cuda):
    table = torch.randn(6, 10, device=cuda)
    with pytest.raises(ValueError, match=">= V"):
        ops.embedding_bag(table, torch.tensor([[0, 6]], dtype=torch.int32, device=cuda))

