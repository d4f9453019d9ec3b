"""The LM family of the port (``repro_torch.models.transformer``) against the
JAX package's (``repro.models.transformer``) on the CPU.

The JAX package's params (``init_params`` with ``jax.random``) go through
``params_from_jax``, and the same numpy-made tokens through both, for the
five LM architectures at their ``smoke_config()`` (deepseek-v2-lite's MLA
included):

  * ``forward`` logits and aux against JAX's at ``attn_impl="naive"`` and
    ``"chunked"``, within 1e-4 absolute (float32);
  * ``prefill`` against JAX's;
  * ``init_cache`` + ``decode_step`` token by token against JAX's
    ``decode_step`` over a cache of 48, which danube's window of 32 cuts;
  * MoE with a capacity factor low enough that tokens are dropped (the
    scatter-max dispatch and the capacity clipping);
  * granite in bfloat16 in both packages, at a bound stated below;
  * attention goes through K4's wrapper ``ops.flash_attention``, exactly
    ``n_layers`` calls a forward and a decode step (on the CPU the wrapper
    runs K4's plain version and counts no launch); MLA's forward calls it
    with a query/key width of qk_nope + qk_rope and a value width of v_dim,
    and its decode step (the absorbed float32 einsums) never;
  * the registry's LM and recsys configs equal JAX's field by field, with
    the dtype mapped (the GNN family's: ``tests/test_torch_gnn.py``).
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf

LM_ARCHS = ["granite-3-2b", "h2o-danube-1.8b", "deepseek-7b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b"]
GNN_ARCHS = ("gcn-cora", "graphcast", "schnet", "gatedgcn")
ATOL = 1e-4          # float32 logits, both packages
SEQ = 48             # past danube's smoke window (32)
BATCH = 2
# bfloat16: each package rounds matmul outputs, attention probabilities (JAX)
# and the residual stream to bfloat16 at its own points, so the logits (rms
# 0.16, largest 0.63) drift by a few bfloat16 steps of the largest over 3
# layers: 0.0125 measured, 2e-2 the bound
BF16_ATOL = 2e-2


def _jax_params(cfg):
    return jtf.init_params(cfg, jax.random.PRNGKey(0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, **overrides):
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config(), **overrides)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config(),
                               **{k: v for k, v in overrides.items() if k != "dtype"})
    if "dtype" in overrides:
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp = _jax_params(jcfg)
    tp = tf.params_from_jax(tcfg, _np_tree(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed=1, batch=BATCH, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq), dtype=np.int32)


class _Count:
    """Counts the calls of ``ops.flash_attention`` (K4's wrapper) and keeps
    the widths (D, Dv) of q and v of each."""

    def __init__(self):
        self.calls = 0
        self.widths = set()
        self._real = ops.flash_attention

    def __call__(self, q, k, v, **kw):
        self.calls += 1
        self.widths.add((q.shape[-1], v.shape[-1]))
        return self._real(q, k, v, **kw)


def _k4_widths(cfg) -> set:
    """The (D, Dv) every K4 call of a forward takes."""
    if cfg.mla is None:
        return {(cfg.head_dim, cfg.head_dim)}
    m = cfg.mla
    return {(m.qk_nope_dim + m.qk_rope_dim, m.v_dim)}


def _cache_names(cfg) -> tuple:
    return ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = _setup(arch, attn_impl=impl)
    toks = _tokens(jcfg)
    exp, exp_aux = jtf.forward(jcfg, jp, jnp.asarray(toks))
    count = _Count()
    with mock.patch.object(ops, "flash_attention", count):
        got, aux = tf.forward(tcfg, tp, torch.from_numpy(toks))
    assert count.calls == tcfg.n_layers and count.widths == _k4_widths(tcfg)
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-5, atol=1e-6)
    if tcfg.moe is not None:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_matches_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    toks = _tokens(jcfg, seed=2)
    exp = np.asarray(jtf.prefill(jcfg, jp, jnp.asarray(toks)))
    got = tf.prefill(tcfg, tp, torch.from_numpy(toks))
    assert got.shape == (BATCH, 1, tcfg.vocab) == exp.shape
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_match_jax(arch):
    """Token by token over a cache of SEQ: every step's logits, the position
    and, at the end, the cache itself against JAX's ``decode_step``; the port
    writes its cache in place.  A step calls K4 once a layer, MLA's never."""
    jcfg, tcfg, jp, tp = _setup(arch)
    names = _cache_names(tcfg)
    toks = _tokens(jcfg, seed=3)
    jcache = jtf.init_cache(jcfg, BATCH, SEQ)
    cache = tf.init_cache(tcfg, BATCH, SEQ, device="cpu")
    assert set(cache) == set(jcache)
    k_buf = cache[names[0]]
    step = jax.jit(lambda c, t: jtf.decode_step(jcfg, jp, c, t))
    count = _Count()
    for t in range(SEQ):
        exp, jcache = step(jcache, jnp.asarray(toks[:, t:t + 1]))
        with mock.patch.object(ops, "flash_attention", count):
            got, out_cache = tf.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
        assert out_cache is cache and cache["pos"] == t + 1 == int(jcache["pos"])
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL,
                                   err_msg=f"step {t}")
    assert count.calls == (0 if tcfg.mla is not None else SEQ * tcfg.n_layers)
    assert cache[names[0]] is k_buf
    for name in names:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="cache is full"):
        tf.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, :1]))


def test_decode_matches_forward():
    """The check of ``tests/test_models_smoke.py``'s
    ``test_lm_smoke_decode_matches_forward`` on the port alone: decode over
    the tokens one by one gives forward's logits (here within 1e-4)."""
    for arch in LM_ARCHS:
        cfg = get_arch(arch).smoke_config()
        tp = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(_tokens(cfg, seed=4))
        logits, _ = tf.forward(cfg, tp, toks)
        cache = tf.init_cache(cfg, BATCH, SEQ, device="cpu")
        dec = torch.cat([tf.decode_step(cfg, tp, cache, toks[:, t:t + 1])[0]
                         for t in range(SEQ)], dim=1)
        assert float((dec - logits).abs().max()) < ATOL, arch


def test_moe_drops_tokens_like_jax():
    """At capacity factor 0.5 a group of 32 tokens with 4 picks over 8
    experts has 8 slots an expert for 16 picks on average: picks are clipped
    and dropped.  The port equals JAX there, and differs from itself at a
    capacity that drops nothing, so the dropping really happened."""
    arch = "granite-moe-1b-a400m"
    base = jax_arch(arch).smoke_config()
    low = dataclasses.replace(base.moe, capacity_factor=0.5)
    jcfg, tcfg, jp, tp = _setup(arch, moe=low)
    toks = _tokens(jcfg, seed=5, seq=32)
    exp, exp_aux = jtf.forward(jcfg, jp, jnp.asarray(toks))
    got, aux = tf.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-5, atol=1e-6)
    roomy = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=100.0))
    assert float((tf.forward(roomy, tp, torch.from_numpy(toks))[0] - got).abs().max()) > 1e-3
    # one layer's dispatch on its own: the same output and aux
    x = np.random.default_rng(6).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    lw = {k: v[0] for k, v in tp["layers"].items()}
    jlw = jax.tree.map(lambda a: a[0], jp["layers"])
    y, a = tf._moe_ffn(torch.from_numpy(x), lw, tcfg)
    ey, ea = jtf._moe_ffn(jnp.asarray(x), jlw, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(a), float(ea), rtol=1e-6)


def test_bfloat16_granite_matches_jax():
    """granite's smoke config in bfloat16 in both packages: forward, prefill
    and four decode steps within ``BF16_ATOL``, and the top-1 token of every
    position equal where JAX's top two logits are more than 2 BF16_ATOL apart."""
    jcfg, tcfg, jp, tp = _setup("granite-3-2b", dtype=jnp.bfloat16)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["ln1"].dtype == torch.float32
    toks = _tokens(jcfg, seed=7)
    exp = np.asarray(jtf.forward(jcfg, jp, jnp.asarray(toks))[0])
    got = tf.forward(tcfg, tp, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=BF16_ATOL)
    top2 = np.sort(exp, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * BF16_ATOL
    assert clear.sum() >= 32
    assert (got.argmax(-1) == exp.argmax(-1))[clear].all()
    np.testing.assert_allclose(tf.prefill(tcfg, tp, torch.from_numpy(toks)).numpy(),
                               np.asarray(jtf.prefill(jcfg, jp, jnp.asarray(toks))),
                               rtol=0, atol=BF16_ATOL)
    jcache = jtf.init_cache(jcfg, BATCH, 8)
    cache = tf.init_cache(tcfg, BATCH, 8, device="cpu")
    assert cache["k"].dtype == torch.bfloat16
    for t in range(4):
        e, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        g, _ = tf.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=BF16_ATOL)


def test_rms_norm_and_rope_match_jax():
    """The two elementwise pieces on their own, float32 and bfloat16: the
    same cast points (float32 inside, the input's dtype out)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 7, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        got = tf.rms_norm(tx, torch.from_numpy(w), 1e-5)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jtf.rms_norm(jx, jnp.asarray(w), 1e-5), np.float32),
                                   rtol=tol, atol=tol)
        got = tf.rope(tx, torch.from_numpy(pos), 10000.0)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jtf.rope(jx, jnp.asarray(pos), 10000.0), np.float32),
                                   rtol=tol, atol=tol)


def test_mla_decode_continues_a_prefill_like_jax():
    """MLA: four decode steps after a cache that forward's prompt filled
    token by token in both packages, then the aux of a forward at 1e-5; and
    the layer's attention inputs: the rope key shared by every head, q's
    rope part rotated at its own width (qk_rope_dim, not head_dim)."""
    jcfg, tcfg, jp, tp = _setup("deepseek-v2-lite-16b")
    m = tcfg.mla
    toks = _tokens(jcfg, seed=9, seq=12)
    jcache = jtf.init_cache(jcfg, BATCH, 12)
    cache = tf.init_cache(tcfg, BATCH, 12, device="cpu")
    for t in range(8):
        _, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        tf.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
    for t in range(8, 12):
        exp, jcache = jtf.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, _ = tf.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=ATOL)
    _, exp_aux = jtf.forward(jcfg, jp, jnp.asarray(toks))
    _, aux = tf.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-5, atol=1e-5)
    h = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (BATCH, 12, tcfg.d_model)).astype(np.float32))
    cos, sin = tf._angles(torch.arange(12), m.qk_rope_dim, tcfg.rope_theta)
    q, k, v = tf._mla_qkv(tcfg, {n: a[0] for n, a in tp["layers"].items()}, h, cos, sin)
    qk = m.qk_nope_dim + m.qk_rope_dim
    assert q.shape == k.shape == (BATCH, tcfg.n_heads, 12, qk) and k.is_contiguous()
    assert v.shape == (BATCH, tcfg.n_heads, 12, m.v_dim) and v.is_contiguous()
    assert torch.equal(k[:, :1, :, m.qk_nope_dim:].expand(-1, tcfg.n_heads, -1, -1),
                       k[..., m.qk_nope_dim:])


def test_mla_params_from_jax_keep_the_tree():
    """MLA's layer leaves (wq, w_dkv, w_krope, w_uk, w_uv, wo and the MoE's)
    cross whole; ``init_params`` draws the same tree with JAX's shapes."""
    arch = "deepseek-v2-lite-16b"
    cfg = jax_arch(arch).smoke_config()
    jp = _np_tree(_jax_params(cfg))
    tp = tf.params_from_jax(get_arch(arch).smoke_config(), jp, device="cpu")
    assert {"w_dkv", "w_krope", "w_uk", "w_uv"} <= set(jp["layers"]) == set(tp["layers"])
    for name, a in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), a)
    mine = tf.init_params(get_arch(arch).smoke_config(), torch.Generator().manual_seed(0),
                          device="cpu")
    assert {n: tuple(t.shape) for n, t in mine["layers"].items()} == {
        n: a.shape for n, a in jp["layers"].items()}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.").split(".")[-1].split("'")[0]
    return out


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS if a not in GNN_ARCHS])
def test_registry_configs_equal_jax(arch):
    """Every ported config equals the JAX package's field by field (nested
    MoE and MLA configs too), the dtype mapped by name; so do the shapes."""
    mine, theirs = get_arch(arch), jax_arch(arch)
    assert (mine.ARCH_ID, mine.FAMILY, mine.SHAPES) == (theirs.ARCH_ID, theirs.FAMILY,
                                                        theirs.SHAPES)
    for which in ("full_config", "smoke_config"):
        a, b = getattr(mine, which)(), getattr(theirs, which)()
        fa, fb = _fields(a), _fields(b)
        fb["dtype"] = np.dtype(b.dtype).name
        assert fa == fb, (arch, which)
        assert isinstance(a.dtype, torch.dtype)
        if hasattr(a, "param_count"):
            assert a.param_count() == b.param_count()
            assert a.active_param_count() == b.active_param_count()
    if arch == "xdeepfm":
        from repro.configs.xdeepfm_cfg import RECSYS_SHAPES as J
        assert mine.RECSYS_SHAPES == J
    else:
        from repro.configs.lm_cells import LM_SHAPES as J
        from repro_torch.configs.lm_cells import LM_SHAPES
        assert LM_SHAPES == J


def test_registry_names_what_is_not_ported():
    assert set(ALL_ARCHS) < set(JAX_ARCHS)
    for arch in set(JAX_ARCHS) - set(ALL_ARCHS):
        with pytest.raises(KeyError, match="ROADMAP.md Queue 1"):
            get_arch(arch)


def test_params_from_jax_keeps_the_tree():
    cfg = jax_arch("granite-moe-1b-a400m").smoke_config()
    jp = _np_tree(_jax_params(cfg))
    tp = tf.params_from_jax(get_arch("granite-moe-1b-a400m").smoke_config(), jp, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name, a in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == a.shape and a.shape[0] == cfg.n_layers
        np.testing.assert_array_equal(tp["layers"][name].numpy(), a)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_has_jax_shapes_dtypes_and_scales(arch):
    """``init_params`` draws from a torch generator: the numbers differ from
    ``jax.random``'s, the shapes, dtypes and scales do not."""
    cfg = jax_arch(arch).full_config()
    shapes = jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0)))
    small = get_arch(arch).smoke_config()
    jsmall = jax_arch(arch).smoke_config()
    tp = tf.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    jp = _np_tree(_jax_params(jsmall))
    for name, a in jp["layers"].items():
        t = tp["layers"][name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype).removeprefix("torch.") == np.dtype(a.dtype).name, name
        if name not in ("ln1", "ln2"):
            assert abs(float(t.float().std()) / float(a.std()) - 1) < 0.2, name
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    assert abs(float(tp["embed"].std()) - 0.02) < 0.003
    # the full config's tree has the same keys as JAX's (no weights made)
    assert set(shapes["layers"]) == set(tp["layers"])
