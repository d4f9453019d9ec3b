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
``pipeline_apply`` against the sequential run in torch.  It imports the
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
        run_compress(job, world, rank, res)
        run_train(job, world, rank, res, out)
        run_zero_specs(job, world, res)
        run_dstlocal(job, world, res)
        run_pipeline(job, world, rank, res)
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
