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
``_opt_pspecs``).  ``lm_cell`` gives the family's dry-run cells
(``launch.dryrun``): JAX's specs, placements and ``meta``, with one rank's
train step, prefill or decode step as ``fn``.  The port has no tensor
parallelism over ``"model"`` (ROADMAP.md Queue 1, item 12.3's
tensor-parallel half), so a cell on a mesh whose model axis has more than
one rank is ``skip``, its specs and ``meta`` still filled.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.cell import (CellSpec, TensorSpec, batch_pspec, data_axes_of, dp_size,
                                      host_step, model_size, specs_of, zero_pspecs)
from repro_torch.launch.mesh import MODEL_AXIS, ONE_RANK, AxisGroup, P, axis_group, sum_over
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


def make_train_step(cfg: tf.LMConfig, n_accum: int, mesh, local_batch: bool = False):
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
    collective.  With ``local_batch`` each rank is given its own rows of the
    batch alone (its ``batch_pspec`` block, as a dry-run cell places it) and
    microbatch i is its i-th run of rows.  Collective: every rank of the
    mesh calls each step."""
    ag = _data_group(mesh)

    def train_step(params, opt_state, batch):
        B, S = batch["tokens"].shape
        if local_batch:
            B *= ag.size
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
            lo = i * b if local_batch else i * bm + ag.index * b
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


# ---------------------------------------------------------------------------
# dry-run cells
# ---------------------------------------------------------------------------

TP_SKIP = ("tensor parallelism over the 'model' axis is not ported (ROADMAP.md Queue 1, "
           "item 12.3's tensor-parallel half): a mesh whose model axis has {tp} ranks")


SEQ_SKIP = ("a decode step over a cache split along its sequence over the data axes (batch "
            "{batch} < {dp} data ranks) is not ported (ROADMAP.md Queue 1, item 12.9: "
            "split-softmax decode)")


def _params_specs(cfg: tf.LMConfig):
    return specs_of(tf.init_params(cfg, torch.Generator(), device="meta"))


def _cache_pspecs(cfg: tf.LMConfig, mesh, batch: int):
    """Mesh-aware cache sharding, JAX's. GQA cache [L, B, Hkv, T, Dh]:
    prefer kv-head sharding over the model axis; fall back to head_dim; for
    batch==1 (long-context) shard T over data. MLA cache [L, B, T, lora]
    shards lora over model."""
    axes = data_axes_of(mesh)
    dlead = axes if len(axes) > 1 else axes[0]
    msz = model_size(mesh)
    dp = dp_size(mesh)
    bspec = dlead if batch % dp == 0 and batch >= dp else None
    tspec = None if bspec is not None else dlead
    if cfg.mla is not None:
        return {
            "c_kv": P(None, bspec, tspec, "model" if cfg.mla.kv_lora % msz == 0 else None),
            "k_rope": P(None, bspec, tspec, None),
            "pos": P(),
        }
    if cfg.n_kv_heads % msz == 0:
        head_axis, hd_axis = "model", None
    elif cfg.head_dim % msz == 0:
        head_axis, hd_axis = None, "model"
    else:
        head_axis = hd_axis = None
    spec = P(None, bspec, head_axis, tspec, hd_axis)
    return {"k": spec, "v": spec, "pos": P()}


def _opt_pspecs(params_specs, pspecs, mesh):
    from repro_torch.optim.adamw import AdamWState

    zp = zero_pspecs(params_specs, pspecs, mesh)
    return AdamWState(step=P(), mu=zp, nu=zp, master=zp)


def lm_cell(cfg: tf.LMConfig, arch_id: str, shape: str, mesh, variant: str = "baseline",
            accum_micro_per_device: int = 1, sub_quadratic: bool = False) -> CellSpec:
    """JAX's ``lm_cell``: the cell of ``shape`` for ``cfg`` on ``mesh``
    (``None``: one rank), ``fn`` one rank's step.  The decode cells step at
    the last position of a full cache (``cache_len - 1``; the cache's
    ``pos`` is a host number in the port)."""
    from repro_torch.data.synth import lm_batch_specs
    from repro_torch.launch.analytic import lm_decode_terms, lm_prefill_terms, lm_train_terms
    from repro_torch.optim import adamw_init

    info = LM_SHAPES[shape]
    kind = info["kind"]
    seq, batch = info["seq"], info["batch"]

    if shape == "long_500k" and not sub_quadratic:
        return CellSpec(
            arch=arch_id, shape=shape, kind=kind, fn=None, args=(), placements=None,
            skip="full-attention arch: 500k decode requires sub-quadratic attention "
                 "(see DESIGN.md SS4)",
        )

    # variant knobs (hillclimbing switches these; the port's attention is K4 either way)
    attn_impl = "chunked_skip" if ("skip" in variant or variant == "opt") else "chunked"
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)

    params_specs = _params_specs(cfg)
    pspecs = tf.param_pspecs(cfg)
    dp = dp_size(mesh)
    tp = model_size(mesh)
    skip = TP_SKIP.format(tp=tp) if tp > 1 else None
    common = dict(model_params=cfg.param_count(), active_params=cfg.active_param_count())

    if kind == "train":
        micro = accum_micro_per_device * dp
        n_accum = max(batch // micro, 1)
        opt_specs = specs_of(adamw_init(tf.init_params(cfg, torch.Generator(), device="meta")))
        opt_p = _opt_pspecs(params_specs, pspecs, mesh)
        batch_specs = lm_batch_specs(batch, seq)
        batch_p = {k: batch_pspec(mesh, 1) for k in batch_specs}
        fn = None
        if skip is None:
            step = make_train_step(cfg, n_accum, mesh, local_batch=True)
            fn = lambda params, opt_state, b: step(params, host_step(opt_state), b)  # noqa: E731
        return CellSpec(
            arch=arch_id, shape=shape, kind=kind, fn=fn,
            args=(params_specs, opt_specs, batch_specs),
            placements=(pspecs, opt_p, batch_p),
            out_placements=(pspecs, opt_p, None),
            donate=(0, 1), skip=skip,
            meta=dict(n_accum=n_accum, tokens=batch * seq, **common,
                      analytic=lm_train_terms(cfg, batch, seq, n_accum, dp, tp)),
        )

    if kind == "prefill":
        fn = None if skip else (lambda params, tokens: tf.prefill(cfg, params, tokens))
        return CellSpec(
            arch=arch_id, shape=shape, kind=kind, fn=fn,
            args=(params_specs, TensorSpec((batch, seq), torch.int32)),
            placements=(pspecs, batch_pspec(mesh, 1)), skip=skip,
            meta=dict(tokens=batch * seq, **common,
                      analytic=lm_prefill_terms(cfg, batch, seq, dp, tp)),
        )

    # decode
    cache = tf.init_cache(cfg, batch, seq, device="meta")
    cache_specs = {**specs_of({k: v for k, v in cache.items() if k != "pos"}),
                   "pos": TensorSpec((), torch.int32)}
    cache_p = _cache_pspecs(cfg, mesh, batch)
    tok_p = batch_pspec(mesh, 1) if batch % dp == 0 and batch >= dp else P(None, None)
    if skip is None and dp > 1 and not (batch % dp == 0 and batch >= dp):
        skip = SEQ_SKIP.format(batch=batch, dp=dp)

    def decode(params, cache, tokens):
        pos = cache["pos"]
        if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
            pos = seq - 1
        return tf.decode_step(cfg, params, {**cache, "pos": pos}, tokens)

    return CellSpec(
        arch=arch_id, shape=shape, kind=kind, fn=None if skip else decode,
        args=(params_specs, cache_specs, TensorSpec((batch, 1), torch.int32)),
        placements=(pspecs, cache_p, tok_p),
        out_placements=(None, cache_p),
        donate=(1,), skip=skip,
        meta=dict(tokens=batch, cache_len=seq, **common,
                  analytic=lm_decode_terms(cfg, batch, seq, dp, tp)),
    )
