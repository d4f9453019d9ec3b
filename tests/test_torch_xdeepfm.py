"""xDeepFM of the port (``repro_torch.models.recsys.xdeepfm``) against the JAX
package's (``repro.models.recsys.xdeepfm``) on the CPU, at its
``smoke_config()``: the JAX package's params through ``params_from_jax`` and
the same numpy-made ids through both.

  * ``forward`` within 1e-5, with both gathers through K6's wrapper
    ``ops.embedding_bag`` (two calls a forward: the embedding rows as bags of
    one id, the linear term as one bag of the row's field ids; on the CPU the
    wrapper runs K6's plain version and counts no launch);
  * ``retrieval_score`` at C <= chunk and at C > chunk within 1e-5;
  * ``init_params`` has JAX's shapes and scales.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xdeepfm_cfg as jcfg_mod
from repro.models.recsys import xdeepfm as jx
from repro_torch.configs import xdeepfm_cfg
from repro_torch.kernels import ops
from repro_torch.models.recsys import xdeepfm as tx

ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jcfg_mod.smoke_config(), xdeepfm_cfg.smoke_config()
    jp = jx.init_params(jcfg, jax.random.PRNGKey(0))
    # JAX initialises the MLP biases and the global bias at 0: give them values
    # so that a dropped term shows
    rng = np.random.default_rng(11)
    jp["mlp"] = [{"w": l["w"], "b": jnp.asarray(rng.standard_normal(l["b"].shape) * 0.1,
                                                  jnp.float32)} for l in jp["mlp"]]
    jp["bias"] = jnp.float32(0.25)
    tp = tx.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _ids(cfg, B, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_per_field, (B, cfg.n_fields),
                                                dtype=np.int32)


class _Count:
    def __init__(self):
        self.calls, self.shapes = 0, []
        self._real = ops.embedding_bag

    def __call__(self, table, idx):
        self.calls += 1
        self.shapes.append((tuple(table.shape), tuple(idx.shape)))
        return self._real(table, idx)


@pytest.mark.parametrize("B", [1, 7, 64])
def test_forward_matches_jax(model, B):
    jcfg, tcfg, jp, tp = model
    ids = _ids(jcfg, B, seed=B)
    exp = np.asarray(jx.forward(jcfg, jp, jnp.asarray(ids)))
    count = _Count()
    before = dict(ops.LAUNCHES)
    with mock.patch.object(ops, "embedding_bag", count):
        got = tx.forward(tcfg, tp, torch.from_numpy(ids))
    assert ops.LAUNCHES == before     # the CPU runs the plain version
    V, m, D = tcfg.n_fields * tcfg.vocab_per_field, tcfg.n_fields, tcfg.embed_dim
    assert count.shapes == [((V, D), (B * m, 1)), ((V, 1), (B, m))]
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=ATOL)


def test_forward_uses_every_term(model):
    """The logit moves when any one of the table, the linear weights, the
    CIN, the MLP or the bias changes: no term is left out."""
    jcfg, tcfg, jp, tp = model
    ids = torch.from_numpy(_ids(jcfg, 16, seed=3))
    base = tx.forward(tcfg, tp, ids)
    for key in ("table", "linear", "cin_out", "bias"):
        bent = dict(tp, **{key: tp[key] * 1.5})
        assert float((tx.forward(tcfg, bent, ids) - base).abs().max()) > 1e-6, key
    bent = dict(tp, cin=[w * 1.5 for w in tp["cin"]])
    assert float((tx.forward(tcfg, bent, ids) - base).abs().max()) > 1e-6
    bent = dict(tp, mlp=[dict(l, b=l["b"] + 0.1) for l in tp["mlp"]])
    assert float((tx.forward(tcfg, bent, ids) - base).abs().max()) > 1e-6


@pytest.mark.parametrize("C,chunk", [(50, 25_000), (40, 40), (60, 20), (96, 32)])
def test_retrieval_score_matches_jax(model, C, chunk):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(C)
    user = _ids(jcfg, 1, seed=C + 1)
    cands = rng.integers(0, jcfg.vocab_per_field, C, dtype=np.int32)
    exp = np.asarray(jx.retrieval_score(jcfg, jp, jnp.asarray(user), jnp.asarray(cands),
                                        chunk=chunk))
    count = _Count()
    with mock.patch.object(ops, "embedding_bag", count):
        got = tx.retrieval_score(tcfg, tp, torch.from_numpy(user), torch.from_numpy(cands),
                                 chunk=chunk)
    assert count.calls == 2 * -(-C // chunk)
    assert got.shape == (C,)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=ATOL)
    # each candidate scores as forward on the user's ids with field 0 swapped
    ids = np.repeat(user, C, axis=0)
    ids[:, 0] = cands
    np.testing.assert_allclose(got.numpy(), tx.forward(tcfg, tp, torch.from_numpy(ids)).numpy(),
                               rtol=0, atol=ATOL)


def test_retrieval_score_refuses_a_ragged_last_chunk(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tx.retrieval_score(tcfg, tp, torch.zeros((1, tcfg.n_fields), dtype=torch.int32),
                           torch.zeros(50, dtype=torch.int32), chunk=20)


def test_init_params_has_jax_shapes_and_scales():
    jcfg, tcfg = jcfg_mod.smoke_config(), xdeepfm_cfg.smoke_config()
    jp = jax.tree.map(np.asarray, jx.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tx.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t.numpy(), tp)))
    assert [w.shape for w in jp["cin"]] == [tuple(w.shape) for w in tp["cin"]]
    assert [l["w"].shape for l in jp["mlp"]] == [tuple(l["w"].shape) for l in tp["mlp"]]
    for key in ("table", "linear", "cin_out"):
        assert tuple(tp[key].shape) == jp[key].shape
    # scales against the nominal ones, on the leaves with hundreds of values
    for t, scale in [(tp["table"], 0.01), (tp["linear"], 0.01)] + [
            (w, 1 / np.sqrt(w.shape[1])) for w in tp["cin"]]:
        assert abs(float(t.std()) / scale - 1) < 0.2
    assert all(tp[k].dtype == torch.float32 for k in ("table", "linear", "bias"))
