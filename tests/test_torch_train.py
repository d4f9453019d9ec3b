"""The port's training path (``repro_torch.optim``, ``checkpoint``, ``ft.loop``,
``data.synth``'s ``lm_batch``/``recsys_batch``, the models' losses and
``launch.train``) against the JAX package's on the CPU.

  * ``lm_loss`` and its gradients against ``jax.value_and_grad(repro's
    lm_loss)`` at the five LM archs' ``smoke_config()`` (float32), ``remat``
    on and off, K4's backward running once a layer; xDeepFM's and the four
    GNNs' ``loss_fn`` and gradients likewise.  The same params
    (``params_from_jax``) and JAX-made batches go to both: the port's
    ``lm_batch`` and ``recsys_batch`` draw from a ``torch.Generator``, whose
    numbers JAX's threefry cannot give.  Tolerances: the loss 1e-5, each
    gradient leaf 1e-4 of its largest |value| (float32 products, softmaxes
    and segment sums in other orders).
  * three AdamW steps against ``repro.optim``'s, the learning rate of each
    step from both packages' ``cosine_schedule`` (1e-6: the same float32
    arithmetic in another order), bfloat16 params among the leaves;
  * ``tests/test_substrate.py``'s tests restated for the port (optimizer,
    schedule, checkpoints, async, restart, data determinism);
  * checkpoints across the packages both ways, leaves in
    ``jax.tree.flatten``'s order, bfloat16 as two raw bytes;
  * ``launch.train --device cpu --smoke`` for granite-3-2b, xdeepfm and
    gcn-cora, and ``--fail-at`` resuming to the uninterrupted run's losses.
"""
import dataclasses
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_arch as jax_arch
from repro.data.synth import graph_batch_from_csr as jax_graph_batch
from repro.data.synth import lm_batch as jax_lm_batch
from repro.data.synth import recsys_batch as jax_recsys_batch
from repro.graph import generators as jgen
from repro.models import transformer as jtf
from repro.models.gnn import gatedgcn as jgatedgcn
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphcast as jgraphcast
from repro.models.gnn import schnet as jschnet
from repro.models.recsys import xdeepfm as jxdeepfm
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data.synth import lm_batch, recsys_batch
from repro_torch.ft import FaultTolerantLoop, SimulatedFailure
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import gatedgcn, gcn, graphcast, schnet
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.models.jax_params import tree_from_jax
from repro_torch.models.recsys import xdeepfm
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

LM_ARCHS = ["granite-3-2b", "h2o-danube-1.8b", "deepseek-7b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAMW_TOL = 1e-6
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(got: list, exp, what: str) -> None:
    exp = jax.tree.leaves(exp)
    assert len(got) == len(exp), what
    for i, (g, e) in enumerate(zip(got, exp)):
        e = np.asarray(e, np.float64)
        g = g.detach().double().numpy()
        assert g.shape == e.shape, (what, i)
        scale = max(float(np.abs(e).max()), 1e-30)
        err = float(np.abs(g - e).max())
        assert err <= GRAD_TOL * scale, f"{what} leaf {i}: {err} > {GRAD_TOL} x {scale}"


def _loss_and_grads(loss_of, params):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_of(params)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_grads_match_jax(arch, remat):
    jcfg = dataclasses.replace(jax_arch(arch).smoke_config(), remat=remat)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config(), remat=remat)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tf.params_from_jax(tcfg, _np(jp), device="cpu")
    jb = jax_lm_batch(3, 1, 2, 48, jcfg.vocab)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    exp_loss, exp_grads = jax.value_and_grad(lambda p: jtf.lm_loss(jcfg, p, jb))(jp)
    with mock.patch.object(ref, "flash_attention_bwd_ref",
                           wraps=ref.flash_attention_bwd_ref) as k4_bwd:
        loss, grads = _loss_and_grads(lambda p: tf.lm_loss(tcfg, p, tb), tp)
    assert k4_bwd.call_count == tcfg.n_layers   # the K4 Function's backward, once a layer
    np.testing.assert_allclose(float(loss.detach()), float(exp_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    _grads_close(grads, exp_grads, arch)


def test_xdeepfm_loss_and_grads_match_jax():
    jcfg, tcfg = jax_arch("xdeepfm").smoke_config(), get_arch("xdeepfm").smoke_config()
    jp = jxdeepfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = xdeepfm.params_from_jax(tcfg, _np(jp), device="cpu")
    jb = jax_recsys_batch(1, 2, 64, jcfg.n_fields, jcfg.vocab_per_field)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    exp_loss, exp_grads = jax.value_and_grad(lambda p: jxdeepfm.loss_fn(jcfg, p, jb))(jp)
    with mock.patch.object(ref, "embedding_bag_bwd_ref",
                           wraps=ref.embedding_bag_bwd_ref) as k6_bwd:
        loss, grads = _loss_and_grads(lambda p: xdeepfm.loss_fn(tcfg, p, tb), tp)
    assert k6_bwd.call_count == 2   # both gathers' backward
    np.testing.assert_allclose(float(loss.detach()), float(exp_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    _grads_close(grads, exp_grads, "xdeepfm")


def _gnn_inputs(arch, cfg):
    """(JAX batch, the port's batch, extra args): a random DAG of 64 nodes with
    37 masked padding edges; GraphCast a mesh batch of numpy draws."""
    if arch == "graphcast":
        rng = np.random.default_rng(0)
        n_g, n_mesh = 48, 16
        ids = {"g2m_src": n_g, "g2m_dst": n_mesh, "mesh_src": n_mesh, "mesh_dst": n_mesh,
               "m2g_src": n_mesh, "m2g_dst": n_g}
        arrays = {"grid_x": rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32),
                  **{k: rng.integers(0, hi, 96).astype(np.int32) for k, hi in ids.items()},
                  "target": rng.standard_normal((n_g, cfg.n_vars)).astype(np.float32)}
        return (jgraphcast.MeshBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                graphcast.MeshBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                (n_mesh,))
    g = jgen.random_dag(64, 200, seed=0)
    kw = dict(pad_edges_to=g.m + 37)
    if arch == "gcn-cora":
        jb = jax_graph_batch(g, cfg.d_in, n_classes=cfg.n_classes, **kw)
    elif arch == "gatedgcn":
        jb = jax_graph_batch(g, cfg.d_in, n_classes=cfg.n_classes, d_edge=cfg.d_edge_in, **kw)
    else:
        jb = jax_graph_batch(g, 1, with_pos=True, **kw)
        types = np.random.default_rng(1).integers(0, 5, (g.n, 1)).astype(np.float32)
        jb = jb._replace(x=jnp.asarray(types),
                         y=jnp.asarray(np.linspace(-1, 1, g.n, dtype=np.float32)))
    tb = GraphBatch(*(None if a is None else torch.from_numpy(np.array(a)) for a in jb))
    return jb, tb, ()


@pytest.mark.parametrize("arch", ["gcn-cora", "gatedgcn", "schnet", "graphcast"])
def test_gnn_loss_and_grads_match_jax(arch):
    """GCN's gradient goes through K5's Function (its backward K5 over the
    transposed rows, once a layer); the others through index_add_."""
    jmod, tmod = {"gcn-cora": (jgcn, gcn), "gatedgcn": (jgatedgcn, gatedgcn),
                  "schnet": (jschnet, schnet), "graphcast": (jgraphcast, graphcast)}[arch]
    jcfg, tcfg = jax_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmod.params_from_jax(tcfg, _np(jp), device="cpu")
    jb, tb, extra = _gnn_inputs(arch, jcfg)
    exp_loss, exp_grads = jax.value_and_grad(lambda p: jmod.loss_fn(jcfg, p, jb, *extra))(jp)
    with mock.patch.object(ops, "_ell_spmm", wraps=ops._ell_spmm) as k5:
        loss, grads = _loss_and_grads(lambda p: tmod.loss_fn(tcfg, p, tb, *extra), tp)
    bwd = sum(c.args[3:] == ("ell_spmm_bwd",) for c in k5.call_args_list)
    assert bwd == (tcfg.n_layers if arch == "gcn-cora" else 0)
    np.testing.assert_allclose(float(loss.detach()), float(exp_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    _grads_close(grads, exp_grads, arch)


# ------------------------------------------------------------------ AdamW


def test_adamw_three_steps_match_jax():
    """Three steps from the same params and gradients (a bfloat16 leaf, a
    nested list, a large gradient that the clip scales), the learning rate
    of each step from each package's schedule: params, moments, master and
    the metrics equal."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": [(4,), (2, 2)], "c": (7,)}
    p_np = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
            "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]],
            "c": rng.standard_normal(shapes["c"]).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p_np)
    jp["c"] = jp["c"].astype(jnp.bfloat16)
    tp = tree_from_jax(_np(jp), "cpu")
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                            * (3.0 if step == 1 else 0.1), p_np)
        jg = jax.tree.map(jnp.asarray, g_np)
        jg["c"] = jg["c"].astype(jnp.bfloat16)
        tg = tree_from_jax(_np(jg), "cpu")
        jlr = jax_cosine(jopt.step, 1e-2, warmup=2, total=3)
        tlr = cosine_schedule(topt.step, 1e-2, warmup=2, total=3)
        np.testing.assert_allclose(tlr, float(jlr), rtol=ADAMW_TOL)
        jp, jopt, jm = jax_adamw_update(jg, jopt, jp, jlr, weight_decay=0.1, clip_norm=1.0)
        tp, topt, tm = adamw_update(tg, topt, tp, tlr, weight_decay=0.1, clip_norm=1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=ADAMW_TOL)
        assert int(topt.step) == int(jopt.step) == step + 1
        for name, t, j in (("params", tp, jp), ("mu", topt.mu, jopt.mu), ("nu", topt.nu, jopt.nu),
                           ("master", topt.master, jopt.master)):
            for tl, jl in zip(tree_leaves(t), jax.tree.leaves(j)):
                assert tl.dtype == (torch.bfloat16 if jl.dtype == jnp.bfloat16 else torch.float32)
                np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                                           rtol=ADAMW_TOL, atol=ADAMW_TOL, err_msg=name)


def test_cosine_schedule_matches_jax():
    for s in range(100):
        np.testing.assert_allclose(cosine_schedule(s, 3e-4, warmup=20, total=100),
                                   float(jax_cosine(jnp.int32(s), 3e-4, warmup=20, total=100)),
                                   rtol=ADAMW_TOL)


# ------------------------------------------- tests/test_substrate.py, restated


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = adamw_init(params)
    target = torch.ones(3)
    for _ in range(300):
        w = params["w"].requires_grad_(True)
        loss = torch.sum((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        params, opt, _ = adamw_update({"w": g}, opt, params, 0.05, weight_decay=0.0)
    assert float(loss) < 1e-3


def test_cosine_schedule_shape():
    lrs = [cosine_schedule(s, 1.0, warmup=10, total=100) for s in range(100)]
    assert lrs[0] < lrs[9]          # warmup rises
    assert lrs[10] >= lrs[50] >= lrs[99]  # cosine decays
    assert lrs[99] >= 0.099         # min_frac floor


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 4))}}
    save_checkpoint(str(tmp_path), 5, tree)
    assert latest_step(str(tmp_path)) == 5
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4))}}
    out = restore_checkpoint(str(tmp_path), 5, like)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(4)}, keep=2)
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == [4, 5]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(5)})


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(7, {"x": torch.arange(5)})
    ck.wait()
    assert latest_step(str(tmp_path)) == 7


def test_async_checkpointer_copies_before_the_tree_changes(tmp_path):
    """The save copies the tree at once: an in-place update right after it
    (as ``adamw_update``'s) does not reach the checkpoint."""
    x = torch.zeros(1 << 16)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": x})
    x.fill_(1.0)
    ck.wait()
    assert not restore_checkpoint(str(tmp_path), 1, {"x": x})["x"].any()


def test_fault_tolerant_restart(tmp_path):
    """A crash at step 7, a restart, the final state that of an uninterrupted run."""

    def make_loop(fail_at):
        def step(state, batch):
            return state + batch.sum(), {"s": state}

        return FaultTolerantLoop(step_fn=step, batch_fn=lambda s: torch.full((4,), float(s)),
                                 init_state=torch.tensor(0.0), ckpt_dir=str(tmp_path / "ft"),
                                 ckpt_every=2, fail_at=fail_at)

    loop = make_loop(fail_at=7)
    with pytest.raises(SimulatedFailure):
        loop.run(12)
    loop2 = make_loop(fail_at=None)   # a fresh loop, as a new process would be
    final = loop2.run(12)
    assert float(final) == float(sum(4 * s for s in range(12)))
    # resumed from a durable checkpoint (the step-6 save is asynchronous and may
    # be lost in flight when the crash lands)
    assert loop2.start_step >= 2


def test_data_determinism_and_restart_safety():
    a = lm_batch(seed=3, step=17, batch=4, seq=16, vocab=101, device="cpu")
    b = lm_batch(seed=3, step=17, batch=4, seq=16, vocab=101, device="cpu")
    c = lm_batch(seed=3, step=18, batch=4, seq=16, vocab=101, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])   # next-token shifted
    assert a["tokens"].dtype == torch.int32 and 0 <= int(a["tokens"].min())
    assert int(a["tokens"].max()) < 101
    r1, r2 = recsys_batch(1, 5, 8, 10, 100, device="cpu"), recsys_batch(1, 5, 8, 10, 100, "cpu")
    assert torch.equal(r1["ids"], r2["ids"]) and torch.equal(r1["y"], r2["y"])


def test_synthetic_batches_follow_jax_formulas():
    """The port's batches are JAX's formulas over other random draws: the
    Zipf marginal favours small ids, three tokens in ten echo their
    predecessor's draw plus 7 (so about 0.3 x 0.7 of them equal the token
    before plus 7), and a click is the hash of the first two fields."""
    toks = lm_batch(0, 0, 64, 256, 1000, device="cpu")["tokens"].long()
    jt = np.asarray(jax_lm_batch(0, 0, 64, 256, 1000)["tokens"])
    for t in (toks.numpy(), jt):
        assert abs(np.mean(t < 32) - 0.5) < 0.1          # log-uniform: half below sqrt(V)
        echo = np.mean(t[:, 1:] == np.clip(t[:, :-1] + 7, 0, 999))
        assert 0.17 < echo < 0.25
    r = recsys_batch(2, 3, 4096, 39, 1000, device="cpu")
    ids = r["ids"].numpy().astype(np.uint64)
    h = (ids[:, 0] * np.uint64(2654435761) + ids[:, 1]) % np.uint64(2**32)
    assert np.array_equal(r["y"].numpy(), (h % 97 < 30).astype(np.float32))
    jr = jax_recsys_batch(2, 3, 4096, 39, 1000)
    jh = (np.asarray(jr["ids"]).astype(np.uint64)[:, 0] * np.uint64(2654435761)
          + np.asarray(jr["ids"]).astype(np.uint64)[:, 1]) % np.uint64(2**32)
    assert np.array_equal(np.asarray(jr["y"]), (jh % 97 < 30).astype(np.float32))


# ------------------------------------------------------------- checkpoints


def _cross_tree(pkg):
    """The same tree in either package: a params dict (a float32 list, a
    bfloat16 leaf, a None) and an AdamW state."""
    rng = np.random.default_rng(4)
    w = [rng.standard_normal((3, 2)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    e = rng.standard_normal((4, 2)).astype(np.float32)
    if pkg == "jax":
        params = {"w": [jnp.asarray(a) for a in w], "emb": jnp.asarray(e).astype(jnp.bfloat16),
                  "none": None}
        return (params, jax_adamw_init(params))
    params = {"w": [torch.from_numpy(a) for a in w],
              "emb": torch.from_numpy(e).to(torch.bfloat16), "none": None}
    return (params, adamw_init(params))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _cross_tree("jax")
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    jax_save(str(tmp_path), 3, jtree)
    got = restore_checkpoint(str(tmp_path), 3, _cross_tree("torch"))
    assert isinstance(got[1], AdamWState) and got[0]["none"] is None
    gleaves = tree_leaves(got)
    assert len(gleaves) == len(jleaves)
    for g, j in zip(gleaves, jleaves):
        if g.dtype == torch.bfloat16:
            assert g.view(torch.int16).numpy().tobytes() == j.tobytes()
        else:
            assert np.array_equal(g.numpy(), j)


def test_port_checkpoint_restores_in_jax(tmp_path):
    ttree = _cross_tree("torch")
    ttree[1].mu["w"][0].add_(1.5)   # the state is not all zeros
    save_checkpoint(str(tmp_path), 4, ttree)
    got = jax_restore(str(tmp_path), 4, _cross_tree("jax"))
    for g, t in zip(jax.tree.leaves(got), tree_leaves(ttree)):
        if t.dtype == torch.bfloat16:   # JAX reads the two raw bytes back as |V2
            assert np.asarray(g).tobytes() == t.view(torch.int16).numpy().tobytes()
        else:
            assert np.array_equal(np.asarray(g), t.numpy())


def test_tree_flatten_is_jax_order():
    tree = {"b": [1, (2, None, 3)], "a": {"z": 4, "y": 5}, "c": None}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [5, 4, 1, 2, 3]
    assert tree_unflatten(treedef, leaves) == tree
    assert tree_map(lambda x: x * 2, tree)["b"][1] == (4, None, 6)


# ------------------------------------------------------------------ driver


@pytest.mark.parametrize("arch", ["granite-3-2b", "xdeepfm", "gcn-cora"])
def test_train_driver_runs_on_the_cpu(arch):
    log = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
                      "--device", "cpu"])
    assert [m["step"] for m in log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in log)


def test_train_driver_refuses_graphcast_and_the_card_without_cuda():
    with pytest.raises(SystemExit, match="dryrun"):
        train.main(["--arch", "graphcast", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "gcn-cora", "--smoke"])


@pytest.mark.parametrize("arch", ["granite-3-2b", "gcn-cora"])
def test_fail_at_resumes_to_the_same_losses(arch, tmp_path):
    """``--fail-at 3`` with a checkpoint every 2 steps: the run restarts from
    the latest checkpoint and each step's loss equals the uninterrupted run's."""
    argv = ["--arch", arch, "--smoke", "--steps", "6", "--batch", "2", "--seq", "32",
            "--device", "cpu"]
    plain = train.main(argv)
    log = train.main(argv + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
                             "--fail-at", "3"])
    by_step = {m["step"]: m["loss"] for m in log}   # the loop's step counts the steps done
    assert sorted(by_step) == [1, 2, 3, 4, 5, 6]
    for m in plain:
        assert by_step[m["step"] + 1] == m["loss"], m["step"]
    assert latest_step(str(tmp_path / "ck")) == 6


def test_examples_run_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    examples = os.path.join(os.path.dirname(SRC), "examples")
    r = subprocess.run([sys.executable, os.path.join(examples, "train_lm_torch.py"),
                        "--device", "cpu", "--d-model", "64", "--layers", "2", "--steps", "8",
                        "--seq", "32", "--vocab", "256", "--ckpt-dir", str(tmp_path / "lm"),
                        "--fail-at", "5"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "restarting" in r.stdout and "loss" in r.stdout.splitlines()[-1]
    r = subprocess.run([sys.executable, os.path.join(examples, "gnn_reachability_torch.py"),
                        "--device", "cpu", "--steps", "6"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "acc" in r.stdout.splitlines()[-1]
