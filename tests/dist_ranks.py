"""One rank of a multi-process run of the port's training across ranks.

``tests/test_torch_dist.py`` starts ``world`` of these over gloo on the CPU,
each with its rank, a ``FileStore`` path to meet at and a job file (a pickle
of the inputs, made with numpy and the JAX package's params); each rank
writes a pickle of what it computed to ``<out>/rank<r>.pkl``:

    python tests/dist_ranks.py RANK WORLD STORE JOB OUT

On each mesh of ``world`` ranks it runs: ``quantized_psum_grads`` (rounded
and stochastic); ``make_train_step`` for two steps on every case of the
job, with the ZeRO layout, the gathered state and a checkpoint round trip;
``configs.cell``'s mesh helpers and ``zero_pspecs`` on the job's param
shapes; ``make_dstlocal_loss`` and a ``make_gnn_train_step`` step on it; with a
job's ``gnn_sharded`` entry, SchNet's, GatedGCN's and GraphCast's
``make_sharded_loss`` over each rank's block of a graph, a step on each and
the same losses with a gather whose adjoint does not sum (the control);
``pipeline_apply`` against the sequential run in torch; with a job's
``cells`` entry (``tests/test_torch_distribution_sharded.py``), the
per-rank programs of the dry-run cells: the oracle's row-sharded
``distribute_one`` and serve step, GCN's per-rank loss, xDeepFM's train
step and the LM step on each rank's own rows (``local_batch``), and on
(2, 2) xDeepFM's forward, ``retrieval_score`` and train step with the
tables row-sharded over ``"model"``; with a ``tp`` entry
(``tests/test_torch_tensor_parallel.py``), the LM family with Megatron
tensor parallelism over ``"model"`` (``run_tp``).  A job runs
the parts it has entries for.  It imports the
port only.
"""
import dataclasses
import datetime
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.cell import batch_pspec, data_axes_of, dp_size, zero_pspecs
from repro_torch.configs.gnn_cells import make_gnn_train_step
from repro_torch.configs.lm_cells import make_train_step, opt_layout
from repro_torch.dist import pipeline_apply
from repro_torch.launch.mesh import axis_group, form_mesh, gather_rows
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import gatedgcn
from repro_torch.models.gnn.layers import GraphBatch
from repro_torch.optim import adamw_init, quantized_psum_grads, zero_gather, zero_init, zero_shard
from repro_torch.tree import tree_leaves, tree_map

TIMEOUT = datetime.timedelta(seconds=60)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _spec_tree(specs):
    """PartitionSpecs as plain tuples (picklable without the port)."""
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    return tuple(specs)


def run_compress(job, world, rank, res):
    mesh = form_mesh((world,), ("data",), timeout=TIMEOUT)
    grads = _torch(job["compress"][rank])
    res["compress"] = _np(quantized_psum_grads(grads, mesh))
    gen = torch.Generator().manual_seed(1000 + rank)
    res["compress_sto"] = _np(quantized_psum_grads(grads, mesh, generator=gen))


def run_train(job, world, rank, res, out):
    mesh = form_mesh((world, 1), ("data", "model"), timeout=TIMEOUT)
    res["train"] = {}
    for name, case in job["train"].items():
        cfg = get_arch(case["arch"]).smoke_config()
        params = tf.params_from_jax(cfg, case["params"], device="cpu")
        layout = opt_layout(cfg, params, mesh)
        state = zero_init(params, layout)
        step = make_train_step(cfg, case["n_accum"], mesh)
        batch = _torch(case["batch"])
        losses, metrics = [], None
        for _ in range(2):
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        whole = zero_gather(state, layout)
        res["train"][name] = {
            "loss": losses, "grad_norm": float(metrics["grad_norm"]), "dims": layout.dims,
            "params": _np(params), "state": _np((whole.mu, whole.nu, whole.master)),
            "slice_shapes": [tuple(x.shape) for x in tree_leaves(state.master)]}
        if name == job["ckpt_case"]:
            # the whole state saved once, restored and re-sliced on every rank
            if rank == 0:
                save_checkpoint(f"{out}/ckpt", 2, {"params": params, "opt": whole})
            dist.barrier()
            back = restore_checkpoint(f"{out}/ckpt", 2, {"params": params, "opt": whole})
            mine = zero_shard(back["opt"], layout)
            res["ckpt_ok"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                                     tree_leaves(state)))
            res["ckpt_params_ok"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(back["params"]), tree_leaves(params)))


def run_zero_specs(job, world, res):
    res["zero"], res["mesh_helpers"] = {}, {}
    for shape, names in job["zero_meshes"][world]:
        mesh = form_mesh(shape, names, timeout=TIMEOUT)
        res["mesh_helpers"][(shape, names)] = (data_axes_of(mesh), dp_size(mesh),
                                               tuple(batch_pspec(mesh)),
                                               tuple(batch_pspec(mesh, 2)))
        for arch, shapes in job["zero_shapes"].items():
            cfg = get_arch(arch).full_config()
            specs = zero_pspecs(shapes, tf.param_pspecs(cfg), mesh)
            res["zero"][(arch, shape, names)] = _spec_tree(specs)


def run_dstlocal(job, world, res):
    dl = job["dstlocal"]
    cfg = gatedgcn.GatedGCNConfig(**dl["cfg"])
    res["dstlocal"] = {}
    for key, (shape, names) in dl["meshes"].items():
        if int(np.prod(shape)) != world:
            continue
        mesh = form_mesh(shape, names, timeout=TIMEOUT)
        b = dl["batches"][world]
        g = GraphBatch(**{k: (torch.from_numpy(v) if v is not None else None)
                          for k, v in b.items()})
        loss_fn = gatedgcn.make_dstlocal_loss(cfg, mesh, names)
        params = gatedgcn.params_from_jax(cfg, dl["params"], device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_fn(params, g)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        step = make_gnn_train_step(loss_fn, mesh)
        state = adamw_init(params)
        params, state, metrics = step(params, state, g)
        res["dstlocal"][key] = {"loss": float(loss), "grads": _np(list(grads)),
                                "step_loss": float(metrics["loss"]), "params": _np(params)}
    if "gnn_sharded" in job:
        run_gnn_sharded(job["gnn_sharded"], world, res)


class _UnsummedGather(torch.autograd.Function):
    """The control's exchange: ``dist.sharded.Gather``'s forward with a
    wrong adjoint, each rank keeping its own rows of its own gradient
    instead of their sum over the ranks."""

    @staticmethod
    def forward(ctx, h, ag):
        ctx.ag, ctx.rows = ag, h.shape[0]
        return gather_rows(h, ag) if ag.size > 1 else h.view_as(h)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.ag.index * ctx.rows, ctx.rows), None


def _block(batch: dict, index: int, parts: int):
    """This rank's block of a whole batch of numpy arrays: the node arrays'
    n/P rows and the edge arrays' m/P edges (JAX's layout)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        size = v.shape[0] // parts
        out[k] = torch.from_numpy(v[index * size:(index + 1) * size].copy())
    return out


def run_gnn_sharded(job, world, res):
    """The three per-rank GNN losses on each mesh of ``world`` ranks: loss
    and gradients over this rank's block, one ``make_gnn_train_step``
    step, and, on more than one rank, the loss and gradients through
    ``_UnsummedGather`` (the control)."""
    from unittest import mock

    from repro_torch.dist import sharded
    from repro_torch.models.gnn import graphcast, schnet

    res["gnn_sharded"] = {}
    for key, (shape, names) in job["meshes"].items():
        if int(np.prod(shape)) != world:
            continue
        mesh = form_mesh(shape, names, timeout=TIMEOUT)
        axes = tuple(a for a in names if a != "model")
        ag = axis_group(mesh, axes)
        for name, case in job["models"].items():
            mod = {"schnet": schnet, "gatedgcn": gatedgcn, "graphcast": graphcast}[name]
            cfg = get_arch(case["arch"]).smoke_config()
            mine = _block(case["batch"], ag.index, ag.size)
            if name == "graphcast":
                b = graphcast.MeshBatch(**mine)
                loss_fn = graphcast.make_sharded_loss(cfg, mesh, case["n_mesh"], axes)
            else:
                b = GraphBatch(**mine)
                loss_fn = mod.make_sharded_loss(cfg, mesh, axes)
            params = mod.params_from_jax(cfg, case["params"], device="cpu")
            leaves = [p.requires_grad_(True) for p in tree_leaves(params)]

            def loss_and_grads():
                loss = loss_fn(params, b)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                return float(loss), _np(list(grads))

            out = dict(zip(("loss", "grads"), loss_and_grads()))
            if ag.size > 1:
                wrong = lambda h, ag_, wire=None: _UnsummedGather.apply(h, ag_)  # noqa: E731
                with mock.patch.object(sharded, "gather", wrong):
                    out["control"] = loss_and_grads()
            step = make_gnn_train_step(loss_fn, mesh)
            params, _, metrics = step(params, adamw_init(params), b)
            out.update(step_loss=float(metrics["loss"]), params=_np(params))
            res["gnn_sharded"][(key, name)] = out


def _stage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i])
    return x


def run_pipeline(job, world, rank, res):
    pl = job["pipeline"][world]
    mesh = form_mesh((world,), ("stage",), timeout=TIMEOUT)
    w_all = torch.from_numpy(pl["w"])
    x = torch.from_numpy(pl["x"]).requires_grad_(True)
    proj = torch.from_numpy(pl["proj"])
    w_mine = w_all[rank:rank + 1].clone().requires_grad_(True)
    out = pipeline_apply({"w": w_mine}, x, _stage, mesh)
    gw, gx = torch.autograd.grad((out * proj).sum(), [w_mine, x])
    # the same stages in one process, in turn
    w_ref = w_all.clone().requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    ref = x_ref
    for s in range(world):
        ref = _stage({"w": w_ref[s]}, ref)
    rw, rx = torch.autograd.grad((ref * proj).sum(), [w_ref, x_ref])
    res["pipeline"] = {"out": out.detach().numpy(), "gw": gw[0].numpy(), "gx": gx.numpy(),
                       "ref_out": ref.detach().numpy(), "ref_gw": rw[rank].numpy(),
                       "ref_gx": rx.numpy()}


def _xdeepfm_model_axis(x, cfg, mesh, P: int, d: int) -> dict:
    """xDeepFM with the tables row-sharded over the mesh's model axis (this
    rank's blocks, ``shard_params``): the forward over this data rank's
    rows of the batch, ``retrieval_score`` over its candidates, and a train
    step from the job's params and from them with the table scaled by
    ``clip_scale`` (a gradient norm above the clip): loss, gradient norm,
    this rank's params and its model block of the state (gathered over the
    data ranks), with the step's ZeRO layout."""
    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.optim.adamw import zero_layout

    whole = _torch(x["params"])
    params = xdeepfm.shard_params(cfg, whole, mesh)
    b = x["batch"]["ids"].shape[0] // P
    c = x["cands"].shape[0] // P
    out = {"forward": xdeepfm.forward(cfg, params, torch.from_numpy(
               x["batch"]["ids"][d * b:(d + 1) * b].copy()), mesh).numpy(),
           "retrieval": xdeepfm.retrieval_score(
               cfg, params, torch.from_numpy(x["user"]),
               torch.from_numpy(x["cands"][d * c:(d + 1) * c].copy()), x["chunk"], mesh).numpy(),
           "steps": {}}
    rows = {k: torch.from_numpy(v[d * b:(d + 1) * b].copy()) for k, v in x["batch"].items()}
    for name, scale in (("plain", 1.0), ("clipped", x["clip_scale"])):
        start = _torch(x["params"])   # the step updates the params in place
        start["table"] = start["table"] * scale
        opt_p = zero_pspecs(start, xdeepfm.param_pspecs(cfg), mesh)
        layout = zero_layout(opt_p, mesh)
        mine = xdeepfm.shard_params(cfg, start, mesh)
        state = zero_init(mine, layout)
        mine, state, metrics = xdeepfm_cfg.make_train_step(cfg, mesh, opt_p)(mine, state, rows)
        gathered = zero_gather(state, layout)
        out["steps"][name] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": _np(mine), "state": _np((gathered.mu, gathered.nu, gathered.master)),
            "dims": layout.dims, "over_model": layout.over_model}
    return out


def run_cells(job, world, rank, res):
    """On (world, 1) and, at 4 ranks, (2, 2): the row-sharded steps (every
    case's state after each iteration, this rank's rows, and the serve
    step's verdicts, in both ``row_extract`` modes); GCN's per-rank loss and
    gradients over this rank's block of a graph; an xDeepFM train step over
    this rank's rows of the batch (on (2, 2) with the tables row-sharded
    over ``"model"``: ``_xdeepfm_model_axis``) and LM train steps over its
    rows (on (world, 1))."""
    from repro_torch.configs import xdeepfm_cfg
    from repro_torch.core.distribution_device import LabelState, make_sharded_distribute_one
    from repro_torch.models.gnn import gcn
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.optim.adamw import zero_layout
    from repro_torch.serve.engine import make_row_sharded_serve_step

    shapes = [(world, 1)] + ([(2, 2)] if world == 4 else [])
    res["oracle"] = {}
    for shape in shapes:
        mesh = form_mesh(shape, ("data", "model"), timeout=TIMEOUT)
        P, d = shape[0], dist.get_rank() // shape[1]   # data index: row-major, model last
        for ci, case in enumerate(job["oracle"]["cases"]):
            n, L = case["n"], case["l_max"]
            nl = n // P
            rows = slice(d * nl, (d + 1) * nl)
            edges = [torch.from_numpy(e.reshape(P, -1)[d].copy()) for e in case["edges"]]
            for mode in ("gather", "onehot"):
                step = make_sharded_distribute_one(mesh, n, case["max_steps"], mode)
                state = LabelState(torch.full((nl, L), -1, dtype=torch.int32),
                                   torch.full((nl, L), -1, dtype=torch.int32),
                                   torch.zeros(nl, dtype=torch.int32),
                                   torch.zeros(nl, dtype=torch.int32),
                                   torch.zeros((), dtype=torch.bool))
                states = []
                for vi in case["order"]:
                    state = step(state, torch.tensor(int(vi), dtype=torch.int32), *edges)
                    states.append([t.numpy().copy() for t in state])
                res["oracle"][(shape, ci, mode)] = states
            L_out, L_in = (torch.from_numpy(case[k][rows].copy()) for k in ("L_out", "L_in"))
            q = case["queries"]
            b = q.shape[0] // P
            fn = make_row_sharded_serve_step(mesh)
            res["oracle"][(shape, ci, "serve")] = fn(
                L_out, L_in, torch.from_numpy(q[d * b:(d + 1) * b].copy())).numpy()
        g = job["oracle"]["gcn"]
        cfg = get_arch("gcn-cora").smoke_config()
        params = [{"w": torch.from_numpy(w.copy()).requires_grad_(True)} for w in g["params"]]
        nl, ml = g["x"].shape[0] // P, g["src"].shape[0] // P
        block = GraphBatch(
            x=torch.from_numpy(g["x"][d * nl:(d + 1) * nl].copy()),
            edge_src=torch.from_numpy(g["src"][d * ml:(d + 1) * ml].copy()),
            edge_dst=torch.from_numpy(g["dst"][d * ml:(d + 1) * ml].copy()),
            edge_mask=torch.from_numpy(g["emask"][d * ml:(d + 1) * ml].copy()),
            node_mask=torch.from_numpy(g["nmask"][d * nl:(d + 1) * nl].copy()),
            y=torch.from_numpy(g["y"][d * nl:(d + 1) * nl].copy()))
        loss = gcn.make_sharded_loss(cfg, mesh, ("data",))(params, block)
        grads = torch.autograd.grad(loss, [p["w"] for p in params])
        res["oracle"][(shape, "gcn")] = (float(loss), [x.numpy() for x in grads])
        x = job["oracle"]["xdeepfm"]
        cfg = xdeepfm_cfg.smoke_config()
        if shape[1] > 1:
            res["oracle"][(shape, "xdeepfm_model_axis")] = _xdeepfm_model_axis(x, cfg, mesh, P, d)
            continue   # the LM step over a model axis: run_tp
        params = _torch(x["params"])
        opt_p = zero_pspecs(params, xdeepfm.param_pspecs(cfg), mesh)
        state = zero_init(params, zero_layout(opt_p, mesh))
        b = x["batch"]["ids"].shape[0] // P
        rows = {k: torch.from_numpy(v[d * b:(d + 1) * b].copy()) for k, v in x["batch"].items()}
        params, state, metrics = xdeepfm_cfg.make_train_step(cfg, mesh, opt_p)(params, state,
                                                                               rows)
        res["oracle"][(shape, "xdeepfm")] = (float(metrics["loss"]), _np(params))
        for n_accum in (1, 2):
            lm = job["oracle"]["lm"]
            cfg = get_arch("granite-3-2b").smoke_config()
            params = _torch(lm["params"])
            state = zero_init(params, opt_layout(cfg, params, mesh))
            b = lm["batch"]["tokens"].shape[0] // P
            rows = {k: torch.from_numpy(v[d * b:(d + 1) * b].copy())
                    for k, v in lm["batch"].items()}
            params, state, metrics = make_train_step(cfg, n_accum, mesh, local_batch=True)(
                params, state, rows)
            res["oracle"][(shape, "lm", n_accum)] = (float(metrics["loss"]), _np(params))


def _tp_train(cfg, whole, n_accum, mesh, batch, steps=2) -> dict:
    """``steps`` of ``make_train_step`` from this rank's blocks of
    ``whole``: the losses, the gradient norm, the params and the state
    gathered whole (``zero_gather`` over the data ranks, then
    ``gather_params`` over the model ranks) and the layout's marks."""
    params = tf.shard_params(cfg, whole, mesh)
    layout = opt_layout(cfg, params, mesh)
    state = zero_init(params, layout)
    step = make_train_step(cfg, n_accum, mesh)
    losses, metrics = [], None
    for _ in range(steps):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    st = zero_gather(state, layout)
    return {"loss": losses, "grad_norm": float(metrics["grad_norm"]),
            "params": _np(tf.gather_params(cfg, params, mesh)),
            "state": _np(tuple(tf.gather_params(cfg, t, mesh) for t in (st.mu, st.nu, st.master))),
            "over_model": layout.over_model}


def run_tp(job, world, res):
    """The LM family with tensor parallelism over ``"model"`` on each mesh
    of ``world`` ranks, for every case (arch) of the job, from JAX's params:
    ``shard_params`` then ``gather_params`` (the blocks' shapes, and the
    round trip byte for byte), ``prefill``'s last logits, the decode steps'
    logits and the cache gathered whole (the cache by kv heads, along
    ``head_dim`` or along ``kv_lora``), two train steps, and the same steps
    with ``copy_to_model``'s backward the identity (the control); then the job's ``seq`` cases on this world's
    meshes: the decode over a cache split along its sequence over the data
    ranks (``_tp_decode``)."""
    from unittest import mock

    from repro_torch.dist import tensor_parallel

    tpj = job["tp"]
    res["tp"] = {}
    for key, shape in tpj["meshes"].items():
        if int(np.prod(shape)) != world:
            continue
        mesh = form_mesh(shape, ("data", "model"), timeout=TIMEOUT)
        mg = tensor_parallel.model_group(mesh)
        for arch, case in tpj["cases"].items():
            cfg = get_arch(arch).smoke_config()
            whole = lambda: tf.params_from_jax(cfg, case["params"], device="cpu")  # noqa: E731
            w = whole()
            local = tf.shard_params(cfg, w, mesh)
            back = tf.gather_params(cfg, local, mesh)
            out = {"local_shapes": [tuple(x.shape) for x in tree_leaves(local)],
                   "round_trip": [a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
                                  for a, b in zip(tree_leaves(back), tree_leaves(w))],
                   "prefill": tf.prefill(cfg, local, torch.from_numpy(case["prompt"]), mg).numpy()}
            out["decode"], out["decode_cache"], _, _ = _tp_decode(cfg, local, case["decode"], mg)
            batch = _torch(case["batch"])
            out["train"] = _tp_train(cfg, whole(), case["n_accum"], mesh, batch)
            with mock.patch.object(tensor_parallel._CopyToModel, "backward",
                                   staticmethod(lambda ctx, g: (g, None))):
                out["control"] = _tp_train(cfg, whole(), case["n_accum"], mesh, batch)
            res["tp"][(key, arch)] = out
    meshes = {}
    for name, case in tpj["seq"].items():
        shape = tuple(case["mesh"])
        if int(np.prod(shape)) != world:
            continue
        if shape not in meshes:
            meshes[shape] = form_mesh(shape, ("data", "model"), timeout=TIMEOUT)
        mesh = meshes[shape]
        cfg = get_arch(case["arch"]).smoke_config()
        if case["n_kv_heads"]:
            cfg = dataclasses.replace(cfg, n_kv_heads=case["n_kv_heads"])
        local = tf.shard_params(cfg, tf.params_from_jax(cfg, case["params"], device="cpu"), mesh)
        decode, whole, round_trip, block = _tp_decode(
            cfg, local, case["tokens"], tensor_parallel.model_group(mesh),
            axis_group(mesh, ("data",)))
        res["tp"][("seq", name)] = {"decode": decode, "cache": whole, "round_trip": round_trip,
                                    "block": block}


def _tp_decode(cfg, local, tokens, mg, dg=None):
    """Every step of ``decode_step`` over ``tokens`` (int[B, steps]) from an
    empty cache of ``steps`` positions placed over ``mg`` (and its sequence
    over ``dg``): the logits, the cache gathered whole, whether
    ``shard_cache`` of it gives back this rank's blocks byte for byte, and
    the positions a block."""
    from repro_torch.launch.mesh import ONE_RANK

    dg = dg or ONE_RANK
    toks = torch.from_numpy(tokens)
    cache = tf.init_cache(cfg, toks.shape[0], toks.shape[1], "cpu", mg, dg)
    logits = np.stack([tf.decode_step(cfg, local, cache, toks[:, t:t + 1], mg, dg)[0].numpy()
                       for t in range(toks.shape[1])])
    whole = tf.gather_cache(cfg, cache, mg, dg)
    again = tf.shard_cache(cfg, whole, mg, dg)
    leaves = [k for k in whole if k != "pos"]
    round_trip = all(again[k].numpy().tobytes() == cache[k].numpy().tobytes() for k in leaves)
    block = cache[leaves[0]].shape[3 if cfg.mla is None else 2]
    return logits, _np({k: whole[k] for k in leaves}), round_trip, block


def main(argv) -> int:
    rank, world, store, job_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        res = {}
        if "compress" in job:
            run_compress(job, world, rank, res)
        if "train" in job:
            run_train(job, world, rank, res, out)
        if "zero_shapes" in job:
            run_zero_specs(job, world, res)
        if "dstlocal" in job:
            run_dstlocal(job, world, res)
        if "pipeline" in job:
            run_pipeline(job, world, rank, res)
        if "oracle" in job:
            run_cells(job, world, rank, res)
        if "tp" in job:
            run_tp(job, world, res)
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
