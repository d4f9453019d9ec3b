"""The port's CUDA kernels on the card, against their plain versions.

K1 (label_intersect) and K2 (frontier_or) against their plain versions,
and the device wave build on the card against the reference build.

These tests need a CUDA card and the CUDA toolkit (the kernels build with
``nvcc`` on first use); they carry the ``cuda`` marker and, without a card,
skip.  The file imports nothing of the JAX package, so it runs on a machine
that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
    assert ops.LAUNCHES["frontier_or"] > 0
    assert dev_co.oracle.build_stats["device"]["device"].startswith("cuda")
    _assert_same_labels(ref_co.oracle, dev_co.oracle, name)
    # prune_cap=1: levels that visit more than one row take the dense prune
    _assert_same_labels(ref_co.oracle, build_oracle(g, impl="device", prune_cap=1).oracle,
                        f"{name} dense prune")


def test_device_build_label_growth_on_the_card(cuda):
    from repro_torch.graph.generators import random_dag

    g = random_dag(60, 170, seed=7)
    ref_co = build_oracle(g, impl="reference")
    ops.reset_launches()
    dev_co = build_oracle(g, impl="device", max_wave=16, l_max=2)
    assert ops.LAUNCHES["frontier_or"] > 0
    assert dev_co.oracle.build_stats["device"]["regrows"] > 0
    _assert_same_labels(ref_co.oracle, dev_co.oracle, "l_max growth")
