"""The LM family with Megatron tensor parallelism over ``"model"`` against
the JAX package, on the CPU.

The port runs one process a rank over gloo (``tests/dist_ranks.py``, its
``tp`` job: ``run_tp``), on the meshes (1, 2), (2, 2) and (1, 4) of
``("data", "model")``; the JAX package runs the same functions on one
device in a subprocess beside them.  Every arch's ``smoke_config()`` (GQA
with half a kv head a rank at 4 model ranks, SWA, the MoE by experts, MLA),
with JAX's params (``params_from_jax``) taken to each rank's blocks by
``shard_params``, inputs made with numpy from a seed.  Held:

  * two ``make_train_step`` steps (2 microbatches, masked labels) against
    JAX's ``make_train_step``: the losses, the gradient norm, and the params
    and the AdamW state gathered whole (``zero_gather``, then
    ``gather_params``) within ``TRAIN_TOL``; the gathered params the same
    bytes on every rank; the ZeRO layout marking the leaves
    ``param_pspecs`` splits over ``"model"``;
  * the control: the same steps with ``copy_to_model``'s backward the
    identity (the replicated parameters' gradients partial) rejected;
  * ``prefill``'s last logits and, where the cache splits by kv heads
    (deepseek-7b on every mesh, the GQA archs at 2 model ranks), every
    ``decode_step``'s logits against JAX's within the float32 bound of
    ``tests/test_torch_models_lm.py``; elsewhere the decode raises naming
    ROADMAP.md Queue 1, item 12.10;
  * ``gather_params(shard_params(p))`` equal to ``p`` byte for byte, the
    blocks of ``param_pspecs``' shapes; ``UnevenShard`` where the model
    ranks do not divide a dimension.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.configs.cell import UnevenShard
from repro_torch.models import transformer as tf
from repro_torch.tree import tree_leaves
from test_torch_dist import RUN_TIMEOUT, SRC, TRAIN_TOL, _close, _finish, _kill, _start_world

LM_ARCHS = ["granite-3-2b", "h2o-danube-1.8b", "deepseek-7b", "granite-moe-1b-a400m",
            "deepseek-v2-lite-16b"]
MESHES = {"m12": (1, 2), "m22": (2, 2), "m14": (1, 4)}
WORLDS = (2, 4)
N_ACCUM = 2
# 8 rows of 48 tokens (past danube's window of 32; a rank's rows split the
# MoE's dispatch groups of 32 evenly), a prompt of 2 x 48, 16 decode steps
BATCH, SEQ, PROMPT, DECODE = 8, 48, (2, 48), (2, 16)
ATOL = 1e-4   # float32 logits, tests/test_torch_models_lm.py's

JAX_SNIPPET = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.configs.lm_cells import make_train_step
from repro.models import transformer as jtf
from repro.optim import adamw_init
job = pickle.load(open(sys.argv[1], 'rb'))['tp']
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ('data', 'model'))
res = {}
for arch, case in job['cases'].items():
    cfg = get_arch(arch).smoke_config()
    params = jax.tree.map(jnp.asarray, case['params'])
    batch = {k: jnp.asarray(v) for k, v in case['batch'].items()}
    step = jax.jit(make_train_step(cfg, case['n_accum'], mesh))
    p, st, losses = params, adamw_init(params), []
    for _ in range(2):
        p, st, m = step(p, st, batch)
        losses.append(float(m['loss']))
    out = {'loss': losses, 'grad_norm': float(m['grad_norm']),
           'params': jax.tree.map(np.asarray, p),
           'state': jax.tree.map(np.asarray, (st.mu, st.nu, st.master)),
           'prefill': np.asarray(jtf.prefill(cfg, params, jnp.asarray(case['prompt'])))}
    toks = case['decode']
    cache = jtf.init_cache(cfg, toks.shape[0], toks.shape[1])
    dec = jax.jit(lambda c, t: jtf.decode_step(cfg, params, c, t))
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = dec(cache, jnp.asarray(toks[:, t:t + 1]))
        logits.append(np.asarray(lg))
    out['decode'] = np.stack(logits)
    res[arch] = out
pickle.dump(res, open(sys.argv[2], 'wb'))
print('JAX_TP_OK')
"""


def _tp_job(rng) -> dict:
    cases = {}
    for arch in LM_ARCHS:
        cfg = jax_arch(arch).smoke_config()
        lab = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        lab[0, :40] = -1   # the ranks' rows hold other counts of labels
        lab[5] = -1
        cases[arch] = {
            "n_accum": N_ACCUM,
            "params": jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0))),
            "batch": {"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32),
                      "labels": lab},
            "prompt": rng.integers(0, cfg.vocab, PROMPT).astype(np.int32),
            "decode": rng.integers(0, cfg.vocab, DECODE).astype(np.int32)}
    return {"meshes": MESHES, "cases": cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results on one device and every world's ranks' results on one
    job (the JAX subprocess runs beside the ranks)."""
    tmp = tmp_path_factory.mktemp("tp")
    job = {"tp": _tp_job(np.random.default_rng(7))}
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    jax_out = tmp / "jax.pkl"
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SNIPPET, str(job_path), str(jax_out)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env={**os.environ, "PYTHONPATH": str(SRC)})
    worlds = {w: _start_world(tmp, w, job_path) for w in WORLDS}
    port = {}
    try:
        for w, (out, procs) in worlds.items():
            logs = _finish(procs, RUN_TIMEOUT)
            failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
            assert not failed, (w, failed, "\n".join(log[-3000:] for log in logs))
            for r in range(w):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    for key, rec in pickle.load(f)["tp"].items():
                        port.setdefault(key, []).append(rec)
        log = _finish([jax_proc], RUN_TIMEOUT)[0]
    finally:
        for _, procs in worlds.values():
            _kill(procs)
        _kill([jax_proc])
    assert "JAX_TP_OK" in log, log[-3000:]
    with open(jax_out, "rb") as f:
        jax_res = pickle.load(f)
    return {"job": job["tp"], "jax": jax_res, "port": port}


def _check_train(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TRAIN_TOL, atol=0, err_msg=what)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=TRAIN_TOL, err_msg=what)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(got["params"]),
                                   jax.tree.leaves(want["params"]))):
        _close(a, b, f"{what} param {i}")
    for part, g, w in zip(("mu", "nu", "master"), got["state"], want["state"]):
        for i, (a, b) in enumerate(zip(jax.tree.leaves(g), jax.tree.leaves(w))):
            _close(a, b, f"{what} {part} {i}")


def _model_dims(cfg) -> list:
    """The dimension ``param_pspecs`` splits over ``"model"`` of each leaf
    (``tree_leaves`` order), ``None`` for a replicated leaf."""
    specs = tf.param_pspecs(cfg)
    flat = [specs["embed"], specs["final_ln"]] + [specs["layers"][k]
                                                  for k in sorted(specs["layers"])]
    return [tuple(s).index("model") if "model" in tuple(s) else None for s in flat]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_step_matches_jax(runs, mesh, arch):
    """Two steps on every rank against JAX's one-device steps; the gathered
    params the same bytes on every rank; the ZeRO layout marks exactly the
    leaves split over the model ranks."""
    want = runs["jax"][arch]
    ranks = runs["port"][(mesh, arch)]
    split = [d is not None for d in _model_dims(get_arch(arch).smoke_config())]
    for r, res in enumerate(ranks):
        _check_train(res["train"], want, f"{mesh} {arch} rank {r}")
        for a, b in zip(jax.tree.leaves(res["train"]["params"]),
                        jax.tree.leaves(ranks[0]["train"]["params"])):
            assert a.tobytes() == b.tobytes()
        assert list(res["train"]["over_model"]) == split


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_control_without_copy_to_model_is_rejected(runs, mesh, arch):
    """With ``copy_to_model``'s backward the identity, the replicated
    parameters take a partial gradient: the bound of
    ``test_train_step_matches_jax`` must reject the steps on every rank."""
    want = runs["jax"][arch]
    for r, res in enumerate(runs["port"][(mesh, arch)]):
        with pytest.raises(AssertionError):
            _check_train(res["control"], want, f"{mesh} {arch} rank {r} control")


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_matches_jax(runs, mesh, arch):
    want = runs["jax"][arch]["prefill"]
    for res in runs["port"][(mesh, arch)]:
        assert res["prefill"].shape == want.shape == (PROMPT[0], 1, want.shape[-1])
        np.testing.assert_allclose(res["prefill"], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_steps_match_jax(runs, mesh, arch):
    """Where the cache splits by kv heads over the model ranks (as
    ``configs.lm_cells.lm_cell`` runs a decode cell), every step's logits
    against JAX's ``decode_step``; elsewhere the step raises, naming the
    ROADMAP item that would lift it."""
    cfg = get_arch(arch).smoke_config()
    tp = MESHES[mesh][1]
    by_heads = cfg.mla is None and cfg.n_kv_heads % tp == 0
    want = runs["jax"][arch]["decode"]
    for res in runs["port"][(mesh, arch)]:
        if by_heads:
            assert res["decode"].shape == want.shape
            np.testing.assert_allclose(res["decode"], want, rtol=0, atol=ATOL)
        else:
            assert "ROADMAP.md Queue 1, item 12.10" in res["decode"]
    if arch == "deepseek-7b":
        assert by_heads


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_gather_round_trip(runs, mesh, arch):
    """``gather_params(shard_params(p))`` is ``p`` byte for byte on every
    rank, and each rank's blocks have ``param_pspecs``' shapes."""
    cfg = get_arch(arch).smoke_config()
    tp = MESHES[mesh][1]
    case = runs["job"]["cases"][arch]
    whole = tf.params_from_jax(cfg, case["params"], device="cpu")
    want = [tuple(s // tp if i == d else s for i, s in enumerate(x.shape))
            for x, d in zip(tree_leaves(whole), _model_dims(cfg))]
    for res in runs["port"][(mesh, arch)]:
        assert all(res["round_trip"]) and len(res["round_trip"]) == len(want)
        assert res["local_shapes"] == want


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_shard_params_raises_uneven(arch):
    """Three model ranks divide no smoke config's heads' columns (4 heads):
    ``shard_params`` raises ``UnevenShard``, as JAX's lowering refuses the
    placement."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_mesh

    cfg = get_arch(arch).smoke_config()
    whole = tf.params_from_jax(cfg, jax.tree.map(np.asarray, jtf.init_params(
        jax_arch(arch).smoke_config(), jax.random.PRNGKey(0))), device="cpu")
    try:
        mesh = fake_mesh((1, 3), ("data", "model"))
        with pytest.raises(UnevenShard, match="does not split over 3 model ranks"):
            tf.shard_params(cfg, whole, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
