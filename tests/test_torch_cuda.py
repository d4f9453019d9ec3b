"""The port's CUDA kernels on the card, against their plain versions.

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
