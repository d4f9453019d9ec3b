"""The port's device wave build against the JAX package's: labels byte for byte.

``repro_torch``'s ``impl="device"`` runs here with ``device="cpu"``, so K2's
frontier form (``frontier_expand``) is its plain version; the dataflow
around it (hop-mask scatter, seeding, the level loop, append over the cone,
sparse resets, overflow undo and regrow) is the code the card runs.  Its
``L_out``/``L_in``/``out_len``/``in_len``/``hop_rank`` bytes must equal
JAX's ``distribution_labeling_device(expand="xla")`` (the Pallas expansion
does not run under the installed JAX), its ``reference`` and its ``wave``
builds on the five construction families, the order variants, the
``l_max`` growth cases and multi-word waves.  ``impl="auto"``
routes as JAX does, with ``device`` where JAX, without an accelerator,
picks its host ``wave`` engine.
"""
import numpy as np
import pytest
import torch

import repro.build.engine as jengine
import repro.build.engine_jax as jengine_jax
import repro.graph.generators as jgen
import repro.graph.scc as jscc
import repro_torch.build.engine as tengine
import repro_torch.build.engine_device as tengine_device
import repro_torch.graph.csr as tcsr
from repro_torch.core.api import build_oracle
from repro_torch.kernels import ops
from mesh_ranks import one_rank_mesh
from test_build_engine import _dag_families

FIELDS = ("L_out", "L_in", "out_len", "in_len", "hop_rank")


def _port(g):
    return tcsr.CSRGraph(g.indptr.copy(), g.indices.copy())


def _assert_same_labels(j, t, tag=""):
    for f in FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, f)
        assert a.tobytes() == b.tobytes(), (tag, f)


FAMILIES = _dag_families(np.random.default_rng(0))


@pytest.mark.parametrize("name,g", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_device_byte_identical_all_families(name, g):
    j_dev = jengine_jax.distribution_labeling_device(g, max_wave=32, expand="xla")
    j_ref = jengine.build_distribution_labels(g, impl="reference")
    t = tengine_device.distribution_labeling_device(_port(g), max_wave=32, device="cpu")
    _assert_same_labels(j_dev, t, name)
    _assert_same_labels(j_ref, t, name)


@pytest.mark.parametrize("order_name", ["degree_product", "degree_sum", "random"])
def test_device_byte_identical_under_order_variants(order_name):
    g = jgen.random_dag(120, 360, seed=8)
    j_dev = jengine_jax.distribution_labeling_device(
        g, order_name=order_name, max_wave=32, expand="xla")
    j_ref = jengine.build_distribution_labels(g, impl="reference", order_name=order_name)
    t = tengine.build_distribution_labels(_port(g), impl="device", order_name=order_name,
                                          max_wave=32, device="cpu")
    _assert_same_labels(j_dev, t, order_name)
    _assert_same_labels(j_ref, t, order_name)


def test_device_label_matrix_growth():
    """A tiny starting l_max forces the overflow-undo-regrow path."""
    g = jgen.random_dag(60, 170, seed=7)
    j = jengine_jax.distribution_labeling_device(g, max_wave=16, l_max=2, expand="xla")
    stats = {}
    t = tengine_device.distribution_labeling_device(_port(g), max_wave=16, l_max=2,
                                                     device="cpu", stats_out=stats)
    _assert_same_labels(j, t, "l_max growth")
    _assert_same_labels(jengine.build_distribution_labels(g, impl="reference"), t)
    assert stats["regrows"] > 0 and stats["l_max"] > 2


@pytest.mark.parametrize("prune_cap", [1, 8])
def test_device_dense_prune_branch(prune_cap):
    """A small prune_cap sends JAX's levels that visit more rows through its
    dense all-rows prune (the ``lax.cond`` other branch); the port computes
    each verdict once per claimed row whatever prune_cap says."""
    g = jgen.layered_dag(80, avg_out=2.5, seed=2)
    j = jengine_jax.distribution_labeling_device(g, max_wave=32, expand="xla",
                                                 prune_cap=prune_cap)
    t = tengine.build_distribution_labels(_port(g), impl="device", max_wave=32,
                                          device="cpu", prune_cap=prune_cap)
    _assert_same_labels(j, t, f"prune_cap={prune_cap}")
    _assert_same_labels(jengine.build_distribution_labels(g, impl="reference"), t)


def test_device_min_width_pad():
    """An l_max below the reference's minimum row width that never
    overflows still finalizes to the min-width-8 INVALID-padded layout."""
    g = tcsr.from_edges(3, [0, 1], [1, 2])
    from repro.graph.csr import from_edges

    jg = from_edges(3, [0, 1], [1, 2])
    j = jengine_jax.distribution_labeling_device(jg, max_wave=4, l_max=4, expand="xla")
    t = tengine_device.distribution_labeling_device(g, max_wave=4, l_max=4, device="cpu")
    assert t.L_out.shape == j.L_out.shape == (3, 8)
    _assert_same_labels(j, t, "min width pad")
    _assert_same_labels(jengine.build_distribution_labels(jg, impl="reference"), t)


def test_device_multiword_waves():
    """A 96-member cap: the schedule's widest wave spans more than one
    32-bit word per vertex, so bit 31 and the word split are in use."""
    g = jgen.layered_dag(300, avg_out=1.2, seed=9)
    j_wave = jengine.build_distribution_labels(g, impl="wave")
    stats = {}
    t = tengine_device.distribution_labeling_device(_port(g), max_wave=96, device="cpu",
                                                     stats_out=stats)
    assert stats["member_width"] > 32
    _assert_same_labels(j_wave, t, "96-member waves")


def test_engine_impl_device_routing_and_stats():
    g = jgen.random_dag(70, 200, seed=1)
    j = jengine.build_distribution_labels(g, impl="device", expand="xla")
    before = dict(ops.LAUNCHES)
    t = tengine.build_distribution_labels(_port(g), impl="device", device="cpu")
    assert ops.LAUNCHES == before  # the CPU path launches no kernel
    _assert_same_labels(j, t, "engine impl=device")
    st = t.build_stats
    assert st["impl"] == t.build_impl == "device"
    assert st["scheduler"] == j.build_stats["scheduler"] == "onepass"
    assert st["n_waves"] == j.build_stats["n_waves"] >= 1
    dev = st["device"]
    assert dev["device"] == "cpu" and dev["sweeps"] >= 2 * st["n_waves"]
    # one host read per BFS level, one per sweep
    assert dev["host_reads"] == dev["levels"] + dev["sweeps"]


def test_engine_kwargs_are_checked():
    g = _port(jgen.random_dag(30, 60, seed=2))
    with pytest.raises(TypeError, match="unknown device-engine kwargs"):
        tengine.build_distribution_labels(g, impl="device", device="cpu", expand="xla")
    with pytest.raises(TypeError, match="accepts no extra kwargs"):
        tengine.build_distribution_labels(g, impl="reference", l_max=8)
    # mesh= is a device-engine kwarg, as in JAX: a mesh of one rank builds
    # the same labels through K2's slab form; anything else is no mesh
    with one_rank_mesh() as mesh:
        _assert_same_labels(tengine.build_distribution_labels(g, impl="reference"),
                            tengine.build_distribution_labels(g, impl="device", device="cpu",
                                                              mesh=mesh))
    with pytest.raises(ValueError, match="not a mesh made by form_mesh"):
        tengine.build_distribution_labels(g, impl="device", device="cpu", mesh=object())
    waves = np.array([1] * g.n, dtype=np.int64)  # a caller-given schedule
    t = tengine.build_distribution_labels(g, impl="device", device="cpu", waves=waves)
    assert t.build_stats["n_waves"] == g.n and t.build_stats["device"]["member_width"] == 1
    _assert_same_labels(tengine.build_distribution_labels(g, impl="reference"), t)


def test_auto_routes_tree_family_to_device():
    """xmark@1.0 (n = 6,080, mean exact wave 26.4) passes JAX's probe: JAX's
    CPU host builds it with ``wave``; the port with the device engine."""
    g = jgen.paper_dataset_analogue("xmark", 1.0)
    dag, _ = jscc.condense_to_dag(g)
    j = jengine.build_distribution_labels(dag, impl="auto")
    assert j.build_impl == "wave"
    t = tengine.build_distribution_labels(_port(dag), impl="auto", device="cpu")
    assert t.build_impl == t.build_stats["impl"] == "device"
    assert t.build_stats["n_waves"] == j.build_stats["n_waves"]
    _assert_same_labels(j, t, "xmark auto")


def test_auto_routes_citeseer_to_speculative():
    """citeseer@0.01 (n = 6,939): mean exact wave under 24, so both packages
    pick their host ``speculative`` engine, with the same schedule and
    speculation counts."""
    g = jgen.paper_dataset_analogue("citeseer", 0.01)
    dag, _ = jscc.condense_to_dag(g)
    j = jengine.build_distribution_labels(dag, impl="auto")
    assert j.build_impl == "speculative"
    t = tengine.build_distribution_labels(_port(dag), impl="auto")  # no card needed
    assert t.build_impl == t.build_stats["impl"] == "speculative"
    assert "auto_wanted" not in t.build_stats
    assert t.build_stats["n_waves"] == j.build_stats["n_waves"]
    js, ts = j.build_stats["speculation"], t.build_stats["speculation"]
    assert set(js) == set(ts)
    for k, v in js.items():
        if not isinstance(v, float):
            assert ts[k] == v, k
    _assert_same_labels(j, t, "citeseer auto")


@pytest.mark.parametrize("w", [5, 32, 70])
def test_certification_mask_equal(rng, w):
    import jax.numpy as jnp

    n, wm = 100, (w + 31) // 32
    lim = 2**32 if w >= 32 else 2**w

    def mask():
        m = rng.integers(0, lim, size=(n, wm), dtype=np.uint64).astype(np.uint32)
        m[rng.random(n) < 0.4] = 0
        if w % 32:  # no bits past member w - 1
            m[:, -1] &= np.uint32((1 << (w % 32)) - 1)
        return m

    masks = [mask() for _ in range(4)]
    members = rng.choice(n, size=w, replace=False).astype(np.int32)
    j = np.asarray(jengine_jax.certification_mask(*(jnp.asarray(m) for m in masks),
                                                  jnp.asarray(members), w))
    t = tengine_device.certification_mask(
        *(torch.from_numpy(m.view(np.int32)) for m in masks), members, w)
    assert t.dtype == torch.bool and np.array_equal(j, t.numpy())
    assert j.any() and not j.all()


def test_build_oracle_forwards_device():
    """build_oracle's device reaches the build: on the CPU the device engine
    runs its tensors there and launches no kernel."""
    from repro.core.api import build_oracle as jbuild_oracle

    g = jgen.layered_dag(200, avg_out=1.5, seed=4)
    ops.reset_launches()
    co = build_oracle(_port(g), device="cpu", impl="device")
    assert ops.LAUNCHES["frontier_or"] == 0
    st = co.oracle.build_stats
    assert st["impl"] == "device" and st["device"]["device"] == "cpu"
    jo = jbuild_oracle(g, impl="device")
    _assert_same_labels(jo.oracle, co.oracle, "build_oracle")
    q = np.random.default_rng(1).integers(0, g.n, (500, 2))
    assert np.array_equal(co.serve(q), np.asarray(jo.serve(q)))
