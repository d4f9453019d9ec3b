"""The LM family's shapes (the assignment's) and its data-parallel training
step, the port of ``repro.configs.lm_cells``' ``LM_SHAPES`` and
``make_train_step``:

  train_4k     seq 4,096   global_batch 256   -> train step (fwd+bwd+AdamW,
                                                 grad accumulation)
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   cache 32,768 global_batch 128  -> decode_step
  long_500k    cache 524,288 global_batch 1   -> decode_step; only for
               sub-quadratic archs (SWA)

``make_train_step`` runs one process a rank over a mesh's data group
(``launch.mesh``), its optimizer state ZeRO-sharded
(``optim.adamw.zero_update``, the layout ``opt_layout``, JAX's
``_opt_pspecs``).  ``lm_cell`` and the other step builders lower JAX cells
for the dry run; they wait for the dry-run port (ROADMAP.md Queue 1, item
12.5).
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import data_axes_of, zero_pspecs
from repro_torch.launch.mesh import MODEL_AXIS, ONE_RANK, AxisGroup, axis_group, sum_over
from repro_torch.models import transformer as tf
from repro_torch.optim import cosine_schedule
from repro_torch.optim.adamw import ZeroLayout, zero_layout, zero_update
from repro_torch.tree import tree_leaves

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def opt_layout(cfg: tf.LMConfig, params, mesh) -> ZeroLayout:
    """Where this rank's optimizer state lives: JAX's ``_opt_pspecs``
    (``zero_pspecs`` over ``param_pspecs``) on ``mesh``'s data group
    (``None``: one rank, every leaf whole).  ``zero_init(params, layout)``
    makes the state ``make_train_step``'s step takes."""
    return zero_layout(zero_pspecs(params, tf.param_pspecs(cfg), mesh), mesh)


def _data_group(mesh) -> AxisGroup:
    """The data group a step averages over; ``ValueError`` on a mesh whose
    model axis has more than one rank."""
    if mesh is None:
        return ONE_RANK
    names = tuple(mesh.mesh_dim_names)
    if MODEL_AXIS in names and mesh.size(names.index(MODEL_AXIS)) > 1:
        raise ValueError(
            "tensor parallelism over the 'model' axis is not ported yet (ROADMAP.md Queue 1, "
            f"item 12.3's tensor-parallel half): mesh {names} of shape {tuple(mesh.shape)}")
    return axis_group(mesh, data_axes_of(mesh))


def _loss_share(cfg: tf.LMConfig, params, mb, ag: AxisGroup) -> torch.Tensor:
    """This rank's share of ``lm_loss`` over the whole microbatch, of which
    it holds ``mb``: its labels' cross-entropy over the microbatch's count
    of labels >= 0 (all ranks'), plus 0.01 x its share of the MoE's aux over
    the microbatch's tokens.  The shares sum to JAX's loss, their gradients
    to its gradient."""
    labels = mb["labels"].long()
    mask = labels >= 0
    count = sum_over(mask.sum(), ag).clamp_min(1)
    x, aux = tf._hidden(cfg, params, mb["tokens"], data_group=ag)
    logp = torch.log_softmax(tf._logits(cfg, params, x), dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return -torch.where(mask, ll, 0.0).sum() / count + 0.01 * aux


def _mean_parts(acc: list, layout: ZeroLayout, n_accum: int) -> list:
    """This rank's slice of each leaf's gradient averaged over ranks x
    microbatches, from each rank's float32 accumulators: one
    ``reduce_scatter_tensor`` a sharded leaf, one ``all_reduce`` a whole
    one (``ZeroLayout.mean_part``)."""
    return [layout.mean_part(a, i, layout.group.size * n_accum) for i, a in enumerate(acc)]


def make_train_step(cfg: tf.LMConfig, n_accum: int, mesh):
    """JAX's ``make_train_step``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` over ``n_accum`` microbatches of
    ``batch`` ({tokens, labels} int[B, S], the whole batch on every rank),
    then the warmup + cosine learning rate and AdamW.

    Each rank takes its ``batch_pspec`` slice of each microbatch (rows
    split evenly over the data group, in the group's order), backpropagates
    its share of the microbatch's loss (``_loss_share``: a global masked
    mean and the MoE's aux over the whole microbatch, as JAX's), and
    accumulates float32 gradients; each rank receives its ZeRO slice of
    their average over the data group (``_mean_parts``: one
    ``reduce_scatter_tensor`` a leaf) and the ZeRO-sharded AdamW
    (``zero_update``, ``opt_state`` from ``zero_init(params,
    opt_layout(cfg, params, mesh))``) updates the params in place, the same
    bytes on every rank.  ``metrics["loss"]`` is the mean of the
    microbatches' losses, as JAX's.  ``mesh`` ``None`` runs one rank with no
    collective.  Collective: every rank of the mesh calls each step."""
    ag = _data_group(mesh)

    def train_step(params, opt_state, batch):
        B, S = batch["tokens"].shape
        if B % n_accum or (B // n_accum) % ag.size:
            raise ValueError(f"a batch of {B} does not split into {n_accum} microbatches "
                             f"over {ag.size} ranks")
        bm = B // n_accum
        b = bm // ag.size
        if cfg.moe is not None and (b * S) % min(cfg.moe.group_size, bm * S):
            raise ValueError(f"{b} x {S} tokens a rank split a dispatch group of "
                             f"{min(cfg.moe.group_size, bm * S)}")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        shares = []
        for i in range(n_accum):
            lo = i * bm + ag.index * b
            share = _loss_share(cfg, params, {k: v[lo:lo + b] for k, v in batch.items()}, ag)
            grads = torch.autograd.grad(share * ag.size, leaves, allow_unused=True,
                                        materialize_grads=True)
            for a, g in zip(acc, grads):
                a += g
            del grads
            shares.append(share.detach())
        losses = sum_over(torch.stack(shares), ag)
        layout = opt_layout(cfg, params, mesh)
        parts = _mean_parts(acc, layout, n_accum)
        del acc
        lr = cosine_schedule(opt_state.step, 3e-4, warmup=2000, total=100_000)
        params, opt_state, metrics = zero_update(parts, opt_state, params, lr, layout)
        metrics["loss"] = losses.mean()
        return params, opt_state, metrics

    return train_step
