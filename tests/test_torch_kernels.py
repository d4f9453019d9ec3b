"""K1 label_intersect: the port's kernel module against ``repro``'s.

On the CPU the wrappers run the kernel's plain version, so these tests hold
the plain versions (``repro_torch.kernels.ref``) and the wrapper plumbing
against the JAX package: ``label_intersect_ref`` against the Pallas kernel
in interpret mode (as the JAX package's own tests run it), and
``tier_intersect_ref`` against ``repro.serve.engine._tier_intersect(...,
use_kernel=True)``.  Every comparison is exact: verdicts are booleans.
The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve.engine import _tier_intersect as jax_tier_intersect
from repro_torch.kernels import ops, ref


def _rows(rng, B, L, sorted_prefix):
    """INVALID-padded int32 rows: the oracle's layout (sorted valid prefix,
    INVALID tail) or INVALID scattered anywhere."""
    m = rng.integers(0, 60, size=(B, L)).astype(np.int32)
    if sorted_prefix:
        m.sort(axis=1)
        m[np.arange(L)[None, :] >= rng.integers(0, L + 1, size=B)[:, None]] = -1
    else:
        m[rng.random((B, L)) < 0.3] = -1
    return m


def _identity(B):
    """Queries (i, i): the fused kernel on rows taken as they lie."""
    return torch.arange(B, dtype=torch.int32)[:, None].repeat(1, 2).contiguous()


@pytest.mark.parametrize("sorted_prefix", [False, True])
@pytest.mark.parametrize("B,La,Lb", [(7, 8, 8), (64, 24, 16), (300, 64, 48), (1, 128, 128)])
def test_label_intersect_matches_pallas_interpret(B, La, Lb, sorted_prefix, rng):
    a, b = _rows(rng, B, La, sorted_prefix), _rows(rng, B, Lb, sorted_prefix)
    exp = np.asarray(jops.label_intersect(jnp.asarray(a), jnp.asarray(b),
                                          block_b=64, interpret=True))
    got_ref = ref.label_intersect_ref(torch.from_numpy(a), torch.from_numpy(b))
    got_op = ops.tier_intersect(torch.from_numpy(a), torch.from_numpy(b),
                                _identity(B), max(La, Lb))
    assert got_ref.dtype == torch.bool and got_ref.shape == (B,)
    assert (got_ref.numpy() == exp).all()
    assert (got_op.numpy() == exp).all()


def test_label_intersect_all_padding():
    a = torch.full((16, 8), -1, dtype=torch.int32)
    assert not ops.tier_intersect(a, a, _identity(16), 8).any()
    assert not ref.label_intersect_ref(a, a).any()


@pytest.mark.parametrize("width", [8, 16, 24, 128])
@pytest.mark.parametrize("Lo,Li", [(16, 8), (40, 24)])
def test_tier_intersect_matches_jax_tier_intersect(Lo, Li, width, rng):
    """The fused gather + per-side width clamp, including width > Li (the
    citeseer shape: widest tier 16, L_in 8 wide) and width > both."""
    n, B = 200, 257
    L_out, L_in = _rows(rng, n, Lo, True), _rows(rng, n, Li, True)
    q = rng.integers(0, n, size=(B, 2)).astype(np.int32)
    q[-1] = (n - 1, n - 1)
    exp = np.asarray(jax_tier_intersect(jnp.asarray(L_out), jnp.asarray(L_in),
                                        jnp.asarray(q), width, True))
    args = (torch.from_numpy(L_out), torch.from_numpy(L_in), torch.from_numpy(q), width)
    got_ref = ref.tier_intersect_ref(*args)
    got_op = ops.tier_intersect(*args)
    assert exp.any() and not exp.all()
    assert (got_ref.numpy() == exp).all()
    assert (got_op.numpy() == exp).all()


def test_cpu_wrapper_runs_the_plain_version_without_counting(rng):
    L = torch.from_numpy(_rows(rng, 10, 8, True))
    q = torch.zeros((4, 2), dtype=torch.int32)
    ops.reset_launches()
    ops.tier_intersect(L, L, q, 8)
    assert ops.LAUNCHES == {"label_intersect": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "width", "queries", "n"])
def test_wrapper_rejects_bad_inputs(bad):
    L = torch.zeros((10, 8), dtype=torch.int32)
    q = torch.zeros((4, 2), dtype=torch.int32)
    args = {"L_out": L, "L_in": L, "queries": q, "width": 8}
    if bad == "dtype":
        args["L_out"] = L.long()
    elif bad == "shape":
        args["L_in"] = torch.zeros(10, dtype=torch.int32)
    elif bad == "contiguous":
        args["L_out"] = torch.zeros((8, 10), dtype=torch.int32).t()
    elif bad == "width":
        args["width"] = 0
    elif bad == "queries":
        args["queries"] = torch.zeros((4, 3), dtype=torch.int32)
    else:
        args["L_in"] = torch.zeros((11, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.tier_intersect(**args)

