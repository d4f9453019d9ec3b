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
shapes; a model axis of more than one rank (which must raise);
``make_dstlocal_loss`` and a ``make_gnn_train_step`` step on it;
``pipeline_apply`` against the sequential run in torch; with a job's
``cells`` entry (``tests/test_torch_distribution_sharded.py``), the
per-rank programs of the dry-run cells: the oracle's row-sharded
``distribute_one`` and serve step, GCN's per-rank loss, xDeepFM's train
step and the LM step on each rank's own rows (``local_batch``).  A job runs
the parts it has entries for.  It imports the
port only.
"""
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
from repro_torch.launch.mesh import form_mesh
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
    if world > 1:
        mesh = form_mesh((world // 2, 2), ("data", "model"), timeout=TIMEOUT)
        cfg = get_arch("granite-3-2b").smoke_config()
        try:
            make_train_step(cfg, 1, mesh)
            res["model_axis"] = None
        except ValueError as e:
            res["model_axis"] = str(e)


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


def run_cells(job, world, rank, res):
    """On (world, 1) and, at 4 ranks, (2, 2): the row-sharded steps (every
    case's state after each iteration, this rank's rows, and the serve
    step's verdicts, in both ``row_extract`` modes); GCN's per-rank loss and
    gradients over this rank's block of a graph; an xDeepFM train step and
    LM train steps over this rank's rows of the batch."""
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
        if shape[1] > 1:
            continue   # the LM and xDeepFM steps take no model axis (their cells skip)
        x = job["oracle"]["xdeepfm"]
        cfg = xdeepfm_cfg.smoke_config()
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
