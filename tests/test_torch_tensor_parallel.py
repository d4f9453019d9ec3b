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
  * ``prefill``'s last logits and every ``decode_step``'s logits against
    JAX's within the float32 bound of ``tests/test_torch_models_lm.py``, the
    cache placed as JAX's ``_cache_pspecs`` places it: by kv heads
    (deepseek-7b on every mesh, the GQA archs at 2 model ranks), along
    ``head_dim`` (the GQA archs at 4 model ranks: 2 kv heads, 4 of 16 dims a
    rank) or along ``kv_lora`` (MLA on every mesh); the cache gathered whole
    (``gather_cache``) against JAX's after the last step;
  * the cache split along its sequence over the data ranks (batch 1), in
    the same worlds (``SEQ_CASES``): (2, 1) and (4, 1) with steps past
    every block's boundary and ranks with no key kept (danube's window of
    32 across a boundary), (2, 2) for MLA (the sequence and ``kv_lora``)
    and for GQA with one kv head (the sequence and ``head_dim``), each
    step's logits and the gathered cache against JAX's ``decode_step`` on
    the whole cache, ``shard_cache(gather_cache(c))`` the rank's blocks
    byte for byte;
  * ``gather_params(shard_params(p))`` equal to ``p`` byte for byte, the
    blocks of ``param_pspecs``' shapes; ``UnevenShard`` where the model
    ranks do not divide a dimension.
"""
import dataclasses
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
# decode over a cache split along its sequence (batch 1): name -> (arch,
# mesh, cache length = steps, n_kv_heads or None for the smoke config's).
# danube's window is 32: at 64 positions over 2 ranks the last step keeps
# rank 1's block alone, over 4 ranks it spans three blocks of 16
SEQ_CASES = {"s21_granite": ("granite-3-2b", (2, 1), 32, None),
             "s21_danube": ("h2o-danube-1.8b", (2, 1), 64, None),
             "s41_danube": ("h2o-danube-1.8b", (4, 1), 64, None),
             "s41_mla": ("deepseek-v2-lite-16b", (4, 1), 32, None),
             "s22_mla": ("deepseek-v2-lite-16b", (2, 2), 32, None),
             "s22_granite_kv1": ("granite-3-2b", (2, 2), 32, 1),
             "s22_danube_kv1": ("h2o-danube-1.8b", (2, 2), 64, 1)}

JAX_SNIPPET = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.configs.lm_cells import make_train_step
from repro.models import transformer as jtf
from repro.optim import adamw_init
job = pickle.load(open(sys.argv[1], 'rb'))['tp']

def decode(cfg, params, toks):
    # every step's logits over a cache as long as the steps, and the cache
    cache = jtf.init_cache(cfg, toks.shape[0], toks.shape[1])
    dec = jax.jit(lambda c, t: jtf.decode_step(cfg, params, c, t))
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = dec(cache, jnp.asarray(toks[:, t:t + 1]))
        logits.append(np.asarray(lg))
    return np.stack(logits), {k: np.asarray(v) for k, v in cache.items() if k != 'pos'}

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
    out['decode'], out['decode_cache'] = decode(cfg, params, case['decode'])
    res[arch] = out
for name, case in job['seq'].items():
    cfg = get_arch(case['arch']).smoke_config()
    if case['n_kv_heads']:
        cfg = dataclasses.replace(cfg, n_kv_heads=case['n_kv_heads'])
    params = jax.tree.map(jnp.asarray, case['params'])
    res[('seq', name)] = dict(zip(('decode', 'cache'), decode(cfg, params, case['tokens'])))
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
    seq = {}
    for name, (arch, mesh, steps, n_kv) in SEQ_CASES.items():
        cfg = jax_arch(arch).smoke_config()
        if n_kv:
            cfg = dataclasses.replace(cfg, n_kv_heads=n_kv)
        seq[name] = {"arch": arch, "mesh": mesh, "n_kv_heads": n_kv,
                     "params": jax.tree.map(np.asarray, jtf.init_params(cfg,
                                                                        jax.random.PRNGKey(1))),
                     "tokens": rng.integers(0, cfg.vocab, (1, steps)).astype(np.int32)}
    return {"meshes": MESHES, "cases": cases, "seq": seq}


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


def _check_cache(got: dict, want: dict, what: str) -> None:
    """The port's cache gathered whole against JAX's: the same leaves and
    shapes, within ``ATOL``.  (Not byte for byte: the layers past the first
    read a residual stream that differs from JAX's in its last bits, as the
    logits do.)"""
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_steps_match_jax(runs, mesh, arch):
    """Every step's logits against JAX's ``decode_step``, the cache placed
    over the model ranks as ``configs.lm_cells._cache_pspecs`` places it
    (``transformer.cache_split``): by kv heads, along ``head_dim`` (GQA's 2
    kv heads over 4 ranks) or along ``kv_lora`` (MLA); the cache gathered
    whole against JAX's after the last step."""
    cfg = get_arch(arch).smoke_config()
    tp = MESHES[mesh][1]
    split = tf.cache_split(cfg, tp)
    assert split == ("kv_lora" if cfg.mla is not None else
                     "heads" if cfg.n_kv_heads % tp == 0 else "head_dim")
    if arch == "deepseek-7b":
        assert split == "heads"
    want = runs["jax"][arch]
    for r, res in enumerate(runs["port"][(mesh, arch)]):
        assert res["decode"].shape == want["decode"].shape
        np.testing.assert_allclose(res["decode"], want["decode"], rtol=0, atol=ATOL)
        _check_cache(res["decode_cache"], want["decode_cache"], f"{mesh} {arch} rank {r}")


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_seq_split_decode_matches_jax(runs, case):
    """A decode over a cache split along its sequence over the data ranks
    (batch 1, the tokens the same on every rank), and along ``head_dim`` or
    ``kv_lora`` over the model ranks where the mesh has two: every step's
    logits on every rank and the cache gathered whole against JAX's
    ``decode_step`` on the whole cache; each rank's blocks the same bytes
    after ``shard_cache(gather_cache(...))``; the rank of the last block
    holding no filled key before its block starts."""
    arch, mesh, steps, _ = SEQ_CASES[case]
    want = runs["jax"][("seq", case)]
    ranks = runs["port"][("seq", case)]
    assert len(ranks) == mesh[0] * mesh[1]
    for r, res in enumerate(ranks):
        assert res["decode"].shape == want["decode"].shape == (steps, 1, 1,
                                                               want["decode"].shape[-1])
        np.testing.assert_allclose(res["decode"], want["decode"], rtol=0, atol=ATOL,
                                   err_msg=f"{case} rank {r}")
        _check_cache(res["cache"], want["cache"], f"{case} rank {r}")
        assert res["round_trip"] and res["block"] == steps // mesh[0]


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
