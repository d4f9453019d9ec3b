"""xDeepFM (Lian et al., arXiv:1803.05170): CIN + DNN + linear, the port of
``repro.models.recsys.xdeepfm``.

Assigned config: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP
400-400.  The embedding table (vocab rows x 10) and the linear weights are
the memory hot path; both of ``forward``'s gathers are K6
(``repro_torch.kernels.ops.embedding_bag``, a hand-written CUDA kernel on
the card, its plain version on the CPU) where the JAX package takes
``jnp.take``:

  * the embedding rows are bags of one id, ``[B * m, 1]`` over the
    ``[n_fields * vocab, D]`` table;
  * the linear term, the sum of a row's m field weights, is one bag of m ids
    over the linear weights seen as a ``[n_fields * vocab, 1]`` table.

CIN layer k:  Z = X^k (outer) X^0 -> [B, H_k * m, D];  X^{k+1} = W_k Z
(1x1 conv over the H_k*m axis), sum-pool over D per layer -> logits.

retrieval_cand: one user context scored against C candidate items by
swapping field 0 (item id) per candidate, in chunks of ``chunk`` rows (the
CIN intermediate of a chunk of 25,000 is 7.8 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_layers: Tuple[int, ...] = (400, 400)
    dtype: torch.dtype = torch.float32


def init_params(cfg: XDeepFMConfig, generator: torch.Generator, device="cuda"):
    """Random weights with JAX's shapes and scales, drawn from ``generator``
    (a ``torch.Generator`` on ``device``; its numbers are not
    ``jax.random``'s)."""
    dev = resolve_device(device)
    m, D = cfg.n_fields, cfg.embed_dim
    rows = cfg.n_fields * cfg.vocab_per_field

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev).mul_(scale).to(cfg.dtype)

    params = {
        "table": normal((rows, D), 0.01),
        "linear": normal((rows,), 0.01),
        "cin": [],
        "mlp": [],
        "bias": torch.zeros((), dtype=cfg.dtype, device=dev),
    }
    h_prev = m
    for h in cfg.cin_layers:
        params["cin"].append(normal((h, h_prev * m), 1.0 / np.sqrt(h_prev * m)))
        h_prev = h
    sizes = [m * D] + list(cfg.mlp_layers) + [1]
    for a, b in zip(sizes[:-1], sizes[1:]):
        params["mlp"].append({"w": normal((a, b), 1.0 / np.sqrt(a)),
                              "b": torch.zeros((b,), dtype=cfg.dtype, device=dev)})
    params["cin_out"] = normal((sum(cfg.cin_layers), 1), 0.01)
    return params


def params_from_jax(cfg: XDeepFMConfig, params, device="cuda"):
    """The JAX package's params (``init_params``'s tree, its leaves as numpy
    arrays) as the port's on ``device``, the ``cin`` and ``mlp`` lists kept."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)   # a copy: JAX's are read-only

    return {"table": t(params["table"]), "linear": t(params["linear"]),
            "cin": [t(w) for w in params["cin"]],
            "mlp": [{"w": t(layer["w"]), "b": t(layer["b"])} for layer in params["mlp"]],
            "cin_out": t(params["cin_out"]), "bias": t(params["bias"])}


def _field_ids(cfg: XDeepFMConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids int32[B, n_fields] per-field local ids -> global table rows."""
    offs = torch.arange(cfg.n_fields, dtype=ids.dtype, device=ids.device) * cfg.vocab_per_field
    return ids + offs[None, :]


def _cin(cfg: XDeepFMConfig, params, x0: torch.Tensor) -> torch.Tensor:
    """x0: [B, m, D] -> concat sum-pooled CIN features [B, sum(H)]."""
    B, m, D = x0.shape
    xk = x0
    pooled = []
    for w in params["cin"]:
        h_prev = xk.shape[1]
        z = torch.einsum("bhd,bmd->bhmd", xk, x0).reshape(B, h_prev * m, D)
        xk = torch.relu(torch.einsum("hk,bkd->bhd", w, z))   # [B, H, D]
        pooled.append(xk.sum(dim=-1))
    return torch.cat(pooled, dim=-1)


@torch.no_grad()
def forward(cfg: XDeepFMConfig, params, ids: torch.Tensor) -> torch.Tensor:
    """ids: int32[B, n_fields] -> logits float32[B].  Two K6 launches: the
    embedding rows and the linear term."""
    B, m = ids.shape
    rows = _field_ids(cfg, ids.to(torch.int32)).contiguous()
    emb = ops.embedding_bag(params["table"], rows.view(B * m, 1)).view(B, m, cfg.embed_dim)
    lin = ops.embedding_bag(params["linear"].view(-1, 1), rows)          # [B, 1]
    cin_feat = _cin(cfg, params, emb)
    h = emb.reshape(B, -1)
    for i, layer in enumerate(params["mlp"]):
        h = h @ layer["w"] + layer["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    logit = h[:, 0] + (cin_feat @ params["cin_out"])[:, 0] + lin[:, 0] + params["bias"]
    return logit.float()


def retrieval_score(cfg: XDeepFMConfig, params, user_ids: torch.Tensor,
                    cand_ids: torch.Tensor, chunk: int = 25_000) -> torch.Tensor:
    """Score one user context against C candidates (the retrieval_cand shape).

    user_ids: int32[1, n_fields]; cand_ids: int32[C] (field-0 item ids) ->
    float32[C].  Each candidate row is the user's ids with field 0 swapped;
    candidates stream through in ``chunk``-sized slabs, one at a time, so the
    CIN intermediate [chunk, H*m, D] stays bounded.  C above ``chunk`` must
    be a multiple of it (as in the JAX package)."""
    C = cand_ids.shape[0]
    if C > chunk and C % chunk:
        raise ValueError(f"{C} candidates are not a multiple of the chunk {chunk}")
    step = min(C, chunk)
    out = []
    for i in range(0, C, step):
        ids = user_ids.to(torch.int32).expand(step, cfg.n_fields).clone()
        ids[:, 0] = cand_ids[i:i + step]
        out.append(forward(cfg, params, ids))
    return torch.cat(out)
