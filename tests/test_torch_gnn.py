"""The GNN family of the port (``repro_torch.models.gnn``, its configs, data
and sampler) against the JAX package's (``repro.models.gnn``) on the CPU.

The JAX package's params (``init_params`` with ``jax.random``, the MLP
biases given values so that a dropped term shows) go through
``params_from_jax``, and the same numpy-made graph through both, at each
model's ``smoke_config()``:

  * ``forward`` and ``loss_fn`` of GCN, GatedGCN, SchNet and GraphCast within
    1e-5, on a graph with masked padding edges; GCN's aggregation through
    K5's wrapper ``ops.ell_spmm``, ``n_layers`` calls a forward (on the CPU
    the wrapper runs K5's plain version and counts no launch);
  * ``ell_from_edges`` + ``ops.ell_spmm`` against ``segment_agg`` (the
    port's and JAX's) on the five graph families of
    ``tests/test_serve_engine.py``, with masked edges among the real ones;
  * ``segment_agg``'s sum, mean and max against JAX's;
  * ``graph_batch_from_csr`` and ``sample_block`` array-equal to JAX's for
    the same seed, ``block_shapes`` and the shapes' dims equal;
  * the registry's GNN configs equal JAX's field by field.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data.synth import graph_batch_from_csr as jax_batch
from repro.graph import generators as jgen
from repro.graph.csr import from_edges as jax_from_edges
from repro.graph.sampler import block_shapes as jax_block_shapes
from repro.graph.sampler import sample_block as jax_sample_block
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import schnet as jschnet
from repro.models.gnn.layers import GraphBatch as JGraphBatch
from repro.models.gnn.layers import segment_agg as jax_segment_agg
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_cells import GNN_SHAPES, shape_dims
from repro_torch.data.synth import graph_batch_from_csr
from repro_torch.graph import generators as tgen
from repro_torch.graph.csr import from_edges
from repro_torch.graph.sampler import block_shapes, sample_block
from repro_torch.kernels import ops
from repro_torch.models.gnn import gatedgcn, gcn, graphcast, schnet
from repro_torch.models.gnn.layers import (GraphBatch, ell_from_edges, gcn_sym_coeff,
                                           segment_agg)

ATOL = 1e-5
GNN_ARCHS = ["gcn-cora", "gatedgcn", "schnet", "graphcast"]
MODELS = {"gcn-cora": (jgcn, gcn), "gatedgcn": (jgatedgcn, gatedgcn),
          "schnet": (jschnet, schnet), "graphcast": (jgraphcast, graphcast)}
N_MESH = 16


def _with_biases(tree, rng):
    """JAX's params with every MLP bias ("b", zeros at init) drawn instead."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype) if k == "b"
                    else _with_biases(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return tree


def _torch_batch(jb) -> GraphBatch:
    return GraphBatch(*(None if a is None else torch.from_numpy(np.array(a)) for a in jb))


def _inputs(arch, cfg):
    """(JAX batch, the port's batch, extra args) for ``arch``: a random DAG of
    64 nodes with 37 masked padding edges (GraphCast: a mesh batch of numpy
    draws, as ``tests/test_models_smoke.py`` makes it)."""
    if arch == "graphcast":
        rng = np.random.default_rng(0)
        n_g = 48
        arrays = dict(
            grid_x=rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32),
            g2m_src=rng.integers(0, n_g, 96).astype(np.int32),
            g2m_dst=rng.integers(0, N_MESH, 96).astype(np.int32),
            mesh_src=rng.integers(0, N_MESH, 64).astype(np.int32),
            mesh_dst=rng.integers(0, N_MESH, 64).astype(np.int32),
            m2g_src=rng.integers(0, N_MESH, 96).astype(np.int32),
            m2g_dst=rng.integers(0, n_g, 96).astype(np.int32),
            target=rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32))
        jb = jgraphcast.MeshBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
        tb = graphcast.MeshBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
        return jb, tb, (N_MESH,)
    g = jgen.random_dag(64, 200, seed=0)
    kw = dict(pad_edges_to=g.m + 37)
    if arch == "gcn-cora":
        jb = jax_batch(g, cfg.d_in, n_classes=cfg.n_classes, **kw)
    elif arch == "gatedgcn":
        jb = jax_batch(g, cfg.d_in, n_classes=cfg.n_classes, d_edge=cfg.d_edge_in, **kw)
    else:
        jb = jax_batch(g, 1, with_pos=True, **kw)
        # atom types 0-4 in column 0 (the normal draw would make nearly all 0)
        types = np.random.default_rng(1).integers(0, 5, (g.n, 1)).astype(np.float32)
        jb = jb._replace(x=jnp.asarray(types),
                         y=jnp.asarray(np.linspace(-1, 1, g.n, dtype=np.float32)))
    return jb, _torch_batch(jb), ()


class _CountSpmm:
    """Counts the calls of ``ops.ell_spmm`` (K5's wrapper)."""

    def __init__(self):
        self.calls = 0
        self._real = ops.ell_spmm

    def __call__(self, *a):
        self.calls += 1
        return self._real(*a)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_and_loss_match_jax(arch):
    jmod, tmod = MODELS[arch]
    jcfg, tcfg = jax_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = _with_biases(jmod.init_params(jcfg, jax.random.PRNGKey(0)), np.random.default_rng(2))
    tp = tmod.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jb, tb, extra = _inputs(arch, jcfg)
    exp = np.asarray(jmod.forward(jcfg, jp, jb, *extra))
    count = _CountSpmm()
    with mock.patch.object(ops, "ell_spmm", count):
        got = tmod.forward(tcfg, tp, tb, *extra)
    assert count.calls == (tcfg.n_layers if arch == "gcn-cora" else 0)
    assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
    np.testing.assert_allclose(got.numpy(), exp, rtol=ATOL, atol=ATOL)
    exp_loss = float(jmod.loss_fn(jcfg, jp, jb, *extra))
    got_loss = float(tmod.loss_fn(tcfg, tp, tb, *extra))
    np.testing.assert_allclose(got_loss, exp_loss, rtol=ATOL, atol=ATOL)


def test_gcn_forward_takes_a_prebuilt_ell():
    """GCN over the ELL rows made once (``graph_ell``): the same logits, and
    a graph whose masked edges carry ids the mask hides changes nothing."""
    cfg = get_arch("gcn-cora").smoke_config()
    jb, tb, _ = _inputs("gcn-cora", jax_arch("gcn-cora").smoke_config())
    tp = gcn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    base = gcn.forward(cfg, tp, tb)
    ell = gcn.graph_ell(tb)
    assert torch.equal(gcn.forward(cfg, tp, tb, ell), base)
    pad = ~tb.edge_mask
    moved = tb._replace(edge_src=torch.where(pad, 5, tb.edge_src),
                        edge_dst=torch.where(pad, 9, tb.edge_dst))
    torch.testing.assert_close(gcn.forward(cfg, tp, moved), base, rtol=0, atol=ATOL)


def _graph_families(rng):
    """``tests/test_serve_engine.py``'s five families, in both packages."""
    fams = [("random_dag", "random_dag", (70, 200), dict(seed=1)),
            ("layered_dag", "layered_dag", (80,), dict(avg_out=2.5, seed=2)),
            ("tree_dag", "tree_dag", (90,), dict(branching=4, seed=3))]
    out = [(name, getattr(tgen, fn)(*a, **kw), getattr(jgen, fn)(*a, **kw))
           for name, fn, a, kw in fams]
    for name, n, hi, m in (("cyclic", 60, 60, 170), ("isolated", 80, 40, 60)):
        src, dst = rng.integers(0, hi, m), rng.integers(0, hi, m)
        out.append((name, from_edges(n, src, dst), jax_from_edges(n, src, dst)))
    return out


@pytest.mark.parametrize("family", range(5))
def test_ell_from_edges_matches_segment_agg(family, rng):
    """K5 over ``ell_from_edges``'s rows is GCN's gather and masked segment
    sum: against the port's ``segment_agg`` and JAX's at 1e-5, with a third
    of the real edges masked and 23 padding edges of random ids; each row
    holds its valid in-edges in edge order, then -1 (weight 0), and the
    width is the largest valid in-degree."""
    name, g, jg = _graph_families(rng)[family]
    src, dst = g.edges()
    jsrc, jdst = jg.edges()
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst), name
    m, n = src.shape[0], g.n
    src = np.concatenate([src, rng.integers(0, n, 23)]).astype(np.int32)
    dst = np.concatenate([dst, rng.integers(0, n, 23)]).astype(np.int32)
    mask = np.concatenate([rng.random(m) > 1 / 3, np.zeros(23, bool)])
    coeff = rng.standard_normal(m + 23).astype(np.float32)
    h = rng.standard_normal((n, 5)).astype(np.float32)
    ts, td, tm = (torch.from_numpy(a) for a in (src, dst, mask))
    nbr, wgt = ell_from_edges(ts, td, tm, torch.from_numpy(coeff), n)
    deg = np.bincount(dst[mask], minlength=n)
    assert nbr.dtype == torch.int32 and wgt.dtype == torch.float32
    assert nbr.shape == (n, max(1, deg.max()))
    for i in range(n):
        e = np.flatnonzero(mask & (dst == i))
        assert nbr[i, :deg[i]].tolist() == src[e].tolist(), (name, i)
        assert (nbr[i, deg[i]:] == -1).all() and not wgt[i, deg[i]:].any()
        assert wgt[i, :deg[i]].tolist() == coeff[e].tolist()
    got = ops.ell_spmm(nbr, wgt, torch.from_numpy(h)).numpy()
    msg = h[src] * coeff[:, None]
    mine = segment_agg(torch.from_numpy(msg), td, tm, n, "sum").numpy()
    theirs = np.asarray(jax_segment_agg(jnp.asarray(msg), jnp.asarray(dst), jnp.asarray(mask),
                                        n, "sum"))
    np.testing.assert_allclose(got, mine, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got, theirs, rtol=ATOL, atol=ATOL)


def test_ell_from_edges_with_no_valid_edge():
    nbr, wgt = ell_from_edges(torch.tensor([1, 2], dtype=torch.int32),
                              torch.tensor([0, 0], dtype=torch.int32),
                              torch.zeros(2, dtype=torch.bool), torch.ones(2), 3)
    assert nbr.shape == (3, 1) and (nbr == -1).all() and not wgt.any()


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_segment_agg_and_sym_coeff_match_jax(agg, rng):
    n, m = 30, 90
    msg = rng.standard_normal((m, 6)).astype(np.float32)
    src, dst = rng.integers(0, n, m).astype(np.int32), rng.integers(0, n - 4, m).astype(np.int32)
    mask = rng.random(m) > 0.3
    got = segment_agg(torch.from_numpy(msg), torch.from_numpy(dst), torch.from_numpy(mask), n,
                      agg)
    exp = jax_segment_agg(jnp.asarray(msg), jnp.asarray(dst), jnp.asarray(mask), n, agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=ATOL, atol=ATOL)
    from repro.models.gnn.layers import gcn_sym_coeff as jax_coeff
    np.testing.assert_allclose(
        gcn_sym_coeff(*(torch.from_numpy(a) for a in (src, dst, mask)), n).numpy(),
        np.asarray(jax_coeff(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), n)),
        rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(d_feat=8), dict(d_feat=4, with_pos=True, seed=3),
                                dict(d_feat=3, d_edge=5, pad_edges_to=260, n_classes=4)],
                         ids=["plain", "pos", "edges_padded"])
def test_graph_batch_from_csr_equals_jax(kw):
    d_feat = kw.pop("d_feat")
    tb = graph_batch_from_csr(tgen.random_dag(64, 200, seed=0), d_feat, device="cpu", **kw)
    jb = jax_batch(jgen.random_dag(64, 200, seed=0), d_feat, **kw)
    assert tb._fields == JGraphBatch._fields
    for name, a, b in zip(tb._fields, tb, jb):
        if b is None:
            assert a is None, name
        else:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
            assert a.numpy().dtype == np.asarray(b).dtype, name
    with pytest.raises(ValueError, match="do not fit"):
        graph_batch_from_csr(tgen.random_dag(64, 200, seed=0), 2, pad_edges_to=10, device="cpu")


def test_sample_block_equals_jax():
    """The same draws from the same generator: every array equal, seeds with
    no in-neighbour and an INVALID seed included; ``block_shapes`` and the
    GNN shapes' padded dims equal JAX's."""
    g, jg = tgen.random_dag(300, 900, seed=4), jgen.random_dag(300, 900, seed=4)
    seeds = np.array([0, 5, 17, 299, -1, 150, 42, 7], np.int32)
    got = sample_block(g.reverse(), seeds, (3, 2), np.random.default_rng(5))
    exp = jax_sample_block(jg.reverse(), seeds, (3, 2), np.random.default_rng(5))
    for f in ("nodes", "edge_src", "edge_dst", "edge_mask"):
        assert np.array_equal(getattr(got, f), getattr(exp, f)), f
        assert getattr(got, f).dtype == getattr(exp, f).dtype, f
    assert got.n_seeds == exp.n_seeds == 8 and got.edge_mask.any() and not got.edge_mask.all()
    assert block_shapes(1024, (15, 10)) == jax_block_shapes(1024, (15, 10))
    from repro.configs.gnn_cells import shape_dims as jax_dims
    for shape in GNN_SHAPES:
        assert shape_dims(shape) == jax_dims(shape), shape


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return out


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_registry_gnn_configs_equal_jax(arch):
    """Every GNN config equals the JAX package's field by field, the dtype
    mapped by name; so do the shapes, GraphCast's mesh dims and GatedGCN's
    edge width."""
    mine, theirs = get_arch(arch), jax_arch(arch)
    assert (mine.ARCH_ID, mine.FAMILY, mine.SHAPES) == (theirs.ARCH_ID, theirs.FAMILY,
                                                        theirs.SHAPES)
    for which in ("full_config", "smoke_config"):
        a, b = getattr(mine, which)(), getattr(theirs, which)()
        fb = dataclasses.asdict(b)
        fb["dtype"] = np.dtype(b.dtype).name
        assert _fields(a) == fb, (arch, which)
        assert isinstance(a.dtype, torch.dtype)
    from repro.configs.gnn_cells import GNN_SHAPES as J
    assert GNN_SHAPES == J
    if arch == "graphcast":
        for shape in GNN_SHAPES:
            assert mine.mesh_dims(shape) == theirs.mesh_dims(shape)
    if arch == "gatedgcn":
        assert mine.D_EDGE == theirs.D_EDGE


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_params_has_jax_tree_shapes_and_dtypes(arch):
    """``init_params`` draws from a torch generator: the numbers differ from
    ``jax.random``'s, the tree, shapes and dtypes do not."""
    jmod, tmod = MODELS[arch]
    jcfg, tcfg = jax_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = jax.tree.map(np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tmod.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name
