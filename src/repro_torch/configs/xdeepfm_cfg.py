"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, MLP 400-400.  The port of ``repro.configs.xdeepfm_cfg``.

Shapes:
  train_batch    B=65,536    train step
  serve_p99      B=512       forward (online inference)
  serve_bulk     B=262,144   forward (offline scoring)
  retrieval_cand B=1, C=1,000,000  candidate scoring in chunks of 25,000

Embedding tables row-shard over the model axis in JAX's layout (the 39 x 1M
x 10 table is the memory + gather hot path): each rank holds its row block
of the table and of the linear term, gathers with K6 and sums over the
model ranks (``xdeepfm.forward``'s ``mesh``).  A cell's ``fn`` is one
rank's program over its rows of the batch or its candidates (the train
step's optimizer state ZeRO-sharded over the data axes, as the placements
say).
"""
from __future__ import annotations

import torch

from repro_torch.configs.cell import (CellSpec, TensorSpec, batch_pspec, data_axes_of, host_step,
                                      specs_of)
from repro_torch.launch.mesh import P
from repro_torch.models.recsys import xdeepfm

ARCH_ID = "xdeepfm"
FAMILY = "recsys"
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


def full_config() -> xdeepfm.XDeepFMConfig:
    return xdeepfm.XDeepFMConfig(
        name=ARCH_ID, n_fields=39, embed_dim=10, vocab_per_field=1_000_000,
        cin_layers=(200, 200, 200), mlp_layers=(400, 400),
    )


def smoke_config() -> xdeepfm.XDeepFMConfig:
    return xdeepfm.XDeepFMConfig(
        name=ARCH_ID + "-smoke", n_fields=6, embed_dim=8, vocab_per_field=64,
        cin_layers=(8, 8), mlp_layers=(16,),
    )


def make_train_step(cfg: xdeepfm.XDeepFMConfig, mesh, opt_pspecs):
    """One rank's train step over its rows of the batch: the loss and its
    gradient, averaged over the data axes onto each rank's ZeRO slice
    (``ZeroLayout.mean_part``), the warmup + cosine learning rate (1e-3,
    500, 50,000) and AdamW (weight decay 1e-5) over the sharded state.
    Equal rows a rank, so the global mean loss is the ranks' mean.  On a
    model axis of more than one rank ``params`` hold this rank's blocks of
    the table and the linear term (``xdeepfm.shard_params``) and the
    gradient norm sums their squares over the model ranks.  Collective:
    every rank calls it."""
    from repro_torch.launch.mesh import sum_over
    from repro_torch.optim import cosine_schedule
    from repro_torch.optim.adamw import zero_layout, zero_update
    from repro_torch.tree import tree_leaves

    layout = zero_layout(opt_pspecs, mesh)

    def train_step(params, opt_state, batch):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = xdeepfm.loss_fn(cfg, params, batch, mesh)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        parts = [layout.mean_part(g, i, layout.group.size) for i, g in enumerate(grads)]
        lr = cosine_schedule(opt_state.step, 1e-3, warmup=500, total=50_000)
        params, opt_state, metrics = zero_update(parts, opt_state, params, lr, layout,
                                                 weight_decay=1e-5)
        metrics["loss"] = sum_over(loss.detach(), layout.group) / layout.group.size
        return params, opt_state, metrics

    return train_step


def local_chunk(n: int, chunk: int = 25_000) -> int:
    """The chunk a rank scores its ``n`` candidates in: ``n`` itself up to
    ``chunk``, else the largest divisor of ``n`` that is at most ``chunk``
    and leaves the fewest chunks (``retrieval_score`` takes whole chunks:
    a data rank's 62,500 of 1M on 16 ranks go as 4 of 15,625)."""
    if n <= chunk:
        return n
    k = -(-n // chunk)
    while n % k:
        k += 1
    return n // k


def cells(shape: str, mesh, variant: str = "baseline"):
    from repro_torch.configs.cell import zero_pspecs
    from repro_torch.data.synth import recsys_batch_specs
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import AdamWState

    info = RECSYS_SHAPES[shape]
    cfg = full_config()
    params = xdeepfm.init_params(cfg, torch.Generator(), device="meta")
    params_specs = specs_of(params)
    params_p = xdeepfm.param_pspecs(cfg)

    if info["kind"] == "train":
        B = info["batch"]
        opt_p = zero_pspecs(params_specs, params_p, mesh)
        opt_p = AdamWState(step=P(), mu=opt_p, nu=opt_p, master=opt_p)
        step = make_train_step(cfg, mesh, opt_p.mu)
        return CellSpec(
            arch=ARCH_ID, shape=shape, kind="train",
            fn=lambda params, opt_state, b: step(params, host_step(opt_state), b),
            args=(params_specs, specs_of(adamw_init(params)), recsys_batch_specs(B, cfg.n_fields)),
            placements=(params_p, opt_p, {"ids": batch_pspec(mesh, 1), "y": batch_pspec(mesh, 0)}),
            out_placements=(params_p, opt_p, None),
            donate=(0, 1),
            meta=dict(batch=B, table_rows=cfg.n_fields * cfg.vocab_per_field),
        )

    if info["kind"] == "serve":
        B = info["batch"]
        return CellSpec(
            arch=ARCH_ID, shape=shape, kind="serve",
            fn=lambda params, ids: xdeepfm.forward(cfg, params, ids, mesh),
            args=(params_specs, TensorSpec((B, cfg.n_fields), torch.int32)),
            placements=(params_p, batch_pspec(mesh, 1)),
            meta=dict(batch=B),
        )

    # retrieval: 1 user x 1M candidates
    C = info["n_candidates"]
    axes = data_axes_of(mesh)
    lead = axes if len(axes) > 1 else axes[0]
    return CellSpec(
        arch=ARCH_ID, shape=shape, kind="retrieval",
        fn=lambda params, user, cands: xdeepfm.retrieval_score(
            cfg, params, user, cands, local_chunk(cands.shape[0]), mesh),
        args=(params_specs, TensorSpec((1, cfg.n_fields), torch.int32),
              TensorSpec((C,), torch.int32)),
        placements=(params_p, P(None, None), P(lead)),
        meta=dict(n_candidates=C),
    )
