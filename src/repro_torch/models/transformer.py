"""Decoder-only transformer LM family, the port of ``repro.models.transformer``.

Plain functions over a params dict, as the JAX package has them:

  * dense GQA (granite-3-2b, deepseek-7b)
  * GQA + sliding-window attention (h2o-danube-1.8b)
  * MoE with GShard-style capacity dispatch (granite-moe-1b-a400m,
    deepseek-v2-lite-16b)
  * MLA, multi-head latent attention with a compressed KV cache
    (deepseek-v2-lite-16b)

Layer weights are stacked ``[L, ...]`` as in the JAX package, and the layer
stack is a Python loop over them.  Attention, in ``forward``/``prefill``
and in every ``decode_step``, is K4 (``repro_torch.kernels.ops
.flash_attention``, a hand-written CUDA kernel on the card, its plain
version on the CPU).  The JAX package attends through the XLA mirror
``_attention_scores`` instead; the functions are the same.

MLA's prefill attends through K4 at a query/key width of 192 (128 without
rope, 64 with it, the rope key shared by the heads) and a value width of 128.
Its decode is the JAX package's absorbed attention: float32 einsums over the
compressed cache, in no kernel (the JAX package has none there either).

Decode keeps a preallocated ``[L, B, Hkv, max_len, Dh]`` cache (MLA: the
compressed ``c_kv`` ``[L, B, max_len, kv_lora]`` and ``k_rope``
``[L, B, max_len, rope]``), written in place (``decode_step`` returns the
cache it was given), with ``pos`` a Python int: attention reads the filled
prefix (K4 through ``kv_len``, MLA through a view) without a copy and
without a host read a step.  Over several ranks the cache is placed as
JAX's ``configs.lm_cells._cache_pspecs`` places it (``init_cache``,
``shard_cache``, ``gather_cache``): over the model ranks by kv heads, along
``head_dim`` or along MLA's ``kv_lora`` (``cache_split``), and over the data
ranks along its sequence where the batch is smaller than them; the softmax
over a split contraction or a split sequence is merged by
``dist.split_softmax``.  ``forward`` and ``lm_loss`` are differentiable
(K4's autograd Function runs its backward kernel on the card); ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, as JAX's
``jax.checkpoint``), and only there.  ``attn_impl``, ``chunk_q``,
``chunk_k`` and ``logical_batch_axes`` are kept so that configs read the
same; they change nothing here.  ``param_pspecs`` is JAX's tensor-parallel
layout: ``shard_params`` takes the whole params to a rank's blocks by it
and ``gather_params`` back, and the layer functions, ``prefill`` and
``decode_step`` take an optional model group (``dist.tensor_parallel``:
each rank its block of the heads, the FFN's columns, the experts and the
vocabulary, the collectives written out; ``ONE_RANK``, the default, calls
none) and an optional data group, over whose batch the MoE's aux loss is
then formed (``configs.lm_cells.make_train_step``).  The cast points are the JAX package's:
``rms_norm`` and ``rope`` in float32, the router in float32, the logits in
the model dtype and then float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist import split_softmax
from repro_torch.dist.tensor_parallel import (copy_to_model, gather_from_model, model_group,
                                             reduce_from_model, vocab_parallel_embed)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MODEL_AXIS, ONE_RANK, AxisGroup, P, gather_rows, sum_over
from repro_torch.models.jax_params import tree_from_jax


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024  # tokens per dispatch group (GShard grouping)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True           # recompute each layer in the backward
    attn_impl: str = "naive"     # no effect: attention is always K4
    chunk_q: int = 512           # no effect
    chunk_k: int = 1024          # no effect
    logical_batch_axes: Tuple[str, ...] = ("pod", "data")   # no effect

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.head_dim
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            attn = (
                d * self.n_heads * qk
                + d * (m.kv_lora + m.qk_rope_dim)
                + m.kv_lora * self.n_heads * (m.qk_nope_dim + m.v_dim)
                + self.n_heads * m.v_dim * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.moe is not None:
            mo = self.moe
            ffn = mo.n_experts * 3 * d * mo.d_ff_expert + d * mo.n_experts
            ffn += mo.n_shared * 3 * d * mo.d_ff_shared
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return L * per_layer + V * d + d  # embed (tied logits) + final norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        mo = self.moe
        full = self.param_count()
        all_experts = L * mo.n_experts * 3 * d * mo.d_ff_expert
        active = L * mo.top_k * 3 * d * mo.d_ff_expert
        return full - all_experts + active


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense(gen, shape, dtype, device, layers=None, scale=None):
    """JAX's ``_dense``: normal x 1/sqrt(fan_in), fan_in the first dim of one
    layer's shape; drawn in float32 and cast.  ``layers`` stacks that many
    draws on a new axis 0, drawn one layer at a time (deepseek-v2-lite's
    ``[27, 64, 2048, 1408]`` expert leaves whole would pass through a 20 GB
    float32 temporary)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    if layers is None:
        return torch.randn(shape, generator=gen, device=device).mul_(s).to(dtype)
    out = torch.empty((layers, *shape), dtype=dtype, device=device)
    for l in range(layers):
        out[l] = torch.randn(shape, generator=gen, device=device).mul_(s)
    return out


def init_params(cfg: LMConfig, generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random weights with JAX's shapes, dtypes and scales, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; its numbers are not
    ``jax.random``'s).  Layer leaves are stacked ``[L, ...]``."""
    dev = resolve_device(device)
    d, hd, L, dt = cfg.d_model, cfg.head_dim, cfg.n_layers, cfg.dtype

    def stack(shape, dtype=dt):
        return _dense(generator, shape, dtype, dev, layers=L)

    if cfg.mla is None:
        layer: Dict[str, Any] = {
            "wq": stack((d, cfg.n_heads * hd)),
            "wk": stack((d, cfg.n_kv_heads * hd)),
            "wv": stack((d, cfg.n_kv_heads * hd)),
            "wo": stack((cfg.n_heads * hd, d)),
        }
    else:
        m = cfg.mla
        layer = {
            "wq": stack((d, cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim))),
            "w_dkv": stack((d, m.kv_lora)),
            "w_krope": stack((d, m.qk_rope_dim)),
            "w_uk": stack((m.kv_lora, cfg.n_heads * m.qk_nope_dim)),
            "w_uv": stack((m.kv_lora, cfg.n_heads * m.v_dim)),
            "wo": stack((cfg.n_heads * m.v_dim, d)),
        }
    if cfg.moe is None:
        layer["w_in"] = stack((d, cfg.d_ff))
        layer["w_gate"] = stack((d, cfg.d_ff))
        layer["w_out"] = stack((cfg.d_ff, d))
    else:
        mo = cfg.moe
        layer["router"] = stack((d, mo.n_experts), torch.float32)
        layer["e_in"] = stack((mo.n_experts, d, mo.d_ff_expert))
        layer["e_gate"] = stack((mo.n_experts, d, mo.d_ff_expert))
        layer["e_out"] = stack((mo.n_experts, mo.d_ff_expert, d))
        if mo.n_shared:
            dsh = mo.d_ff_shared or mo.d_ff_expert
            layer["s_in"] = stack((d, mo.n_shared * dsh))
            layer["s_gate"] = stack((d, mo.n_shared * dsh))
            layer["s_out"] = stack((mo.n_shared * dsh, d))
    layer["ln1"] = torch.ones((L, d), dtype=torch.float32, device=dev)
    layer["ln2"] = torch.ones((L, d), dtype=torch.float32, device=dev)
    return {
        "embed": _dense(generator, (cfg.vocab, d), dt, dev, scale=0.02),
        "final_ln": torch.ones((d,), dtype=torch.float32, device=dev),
        "layers": layer,
    }


def params_from_jax(cfg: LMConfig, params, device="cuda") -> Dict[str, Any]:
    """The JAX package's params (``init_params``'s tree, its leaves as numpy
    arrays) as the port's, on ``device``: the same keys, the stacked
    ``[L, ...]`` layer leaves kept (MLA's too), the same dtypes."""
    return tree_from_jax(params, resolve_device(device))


def param_pspecs(cfg: LMConfig, model_axis: str = "model") -> Dict[str, Any]:
    """JAX's Megatron TP layout, as data: column-shard in-projections,
    row-shard out-projections; experts sharded over the model axis (EP);
    embedding vocab-sharded.  ``shard_params`` places the leaves by it and
    ``configs.cell.zero_pspecs`` reads it to pick each leaf's ZeRO
    dimension."""
    M = model_axis
    layer: Dict[str, Any] = {}
    if cfg.mla is None:
        layer["wq"] = P(None, None, M)
        layer["wk"] = P(None, None, M)
        layer["wv"] = P(None, None, M)
        layer["wo"] = P(None, M, None)
    else:
        layer["wq"] = P(None, None, M)
        layer["w_dkv"] = P(None, None, None)   # latent projection replicated
        layer["w_krope"] = P(None, None, None)
        layer["w_uk"] = P(None, None, M)
        layer["w_uv"] = P(None, None, M)
        layer["wo"] = P(None, M, None)
    if cfg.moe is None:
        layer["w_in"] = P(None, None, M)
        layer["w_gate"] = P(None, None, M)
        layer["w_out"] = P(None, M, None)
    else:
        layer["router"] = P(None, None, None)
        layer["e_in"] = P(None, M, None, None)    # EP: experts over model axis
        layer["e_gate"] = P(None, M, None, None)
        layer["e_out"] = P(None, M, None, None)
        if cfg.moe.n_shared:
            layer["s_in"] = P(None, None, M)
            layer["s_gate"] = P(None, None, M)
            layer["s_out"] = P(None, M, None)
    layer["ln1"] = P(None, None)
    layer["ln2"] = P(None, None)
    return {
        "embed": P(M, None),
        "final_ln": P(None),
        "layers": layer,
    }


def _model_dims(cfg: LMConfig) -> Dict[str, Any]:
    """Each leaf's dimension that ``param_pspecs`` splits over the model
    axis (``None``: replicated), in the params' tree."""
    def dim(spec):
        return next((i for i, e in enumerate(spec) if e == MODEL_AXIS), None)

    specs = param_pspecs(cfg)
    return {"embed": dim(specs["embed"]), "final_ln": dim(specs["final_ln"]),
            "layers": {k: dim(v) for k, v in specs["layers"].items()}}


def _map_model_leaves(cfg: LMConfig, tree, fn):
    dims = _model_dims(cfg)
    out = {k: fn(tree[k], dims[k]) for k in ("embed", "final_ln")}
    out["layers"] = {k: fn(v, dims["layers"][k]) for k, v in tree["layers"].items()}
    return out


def shard_params(cfg: LMConfig, params, mesh) -> Dict[str, Any]:
    """This rank's blocks of the whole ``params`` (``init_params``'s or
    ``params_from_jax``'s tree, or a state tree of the same shape) on
    ``mesh``'s model axis, by ``param_pspecs``: copies of the split leaves,
    the replicated ones the same tensors.  ``configs.cell.UnevenShard``
    where the model ranks do not divide a dimension."""
    from repro_torch.configs.cell import UnevenShard

    ag = model_group(mesh)

    def block(x, d):
        if d is None or ag.size == 1:
            return x
        if x.shape[d] % ag.size:
            raise UnevenShard(f"dimension {d} of {tuple(x.shape)} ({x.shape[d]}) does not "
                              f"split over {ag.size} model ranks")
        n = x.shape[d] // ag.size
        return x.narrow(d, ag.index * n, n).clone()

    return _map_model_leaves(cfg, params, block)


def gather_params(cfg: LMConfig, local, mesh) -> Dict[str, Any]:
    """The whole params from every model rank's blocks (``shard_params``'
    inverse; a state tree of the same shape too): one
    ``all_gather_into_tensor`` a split leaf over the model ranks, the
    replicated leaves as they are.  Collective over the model axis."""
    ag = model_group(mesh)

    def whole(x, d):
        if d is None or ag.size == 1:
            return x
        return gather_rows(x.detach().movedim(d, 0).contiguous(), ag).movedim(0, d).contiguous()

    return _map_model_leaves(cfg, local, whole)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def _angles(pos: torch.Tensor, D: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin float32[S, D // 2] of the rotary angles at positions ``pos``."""
    half = D // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(half, dtype=torch.float32,
                                                    device=pos.device) / half)
    ang = pos[:, None].float() * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, D] rotary over the last dim; pos: [S] absolute positions.
    The rotation is taken in float32 and cast back to x's dtype."""
    return _rotate(x, *_angles(pos, x.shape[-1], theta))


def _moe_ffn(x: torch.Tensor, lw, cfg: LMConfig, data_group=None,
             model_group: AxisGroup = ONE_RANK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped capacity-based one-hot dispatch MoE (GShard-style), JAX's
    ``_moe_ffn``.  x: [B, S, d] -> ([B, S, d], aux load-balance loss).

    With ``data_group`` (a ``launch.mesh.AxisGroup`` whose ranks each hold an
    equal slice of one batch), the aux loss is over the group's tokens: the
    top-1 density is summed over the ranks first, and the aux returned is
    this rank's share, the shares summing to the batch's aux.

    Over ``model_group`` (expert parallelism) the router and the dispatch
    run whole on every rank; a rank holds ``E / size`` experts (``e_in``,
    ``e_gate``, ``e_out``: its block of the experts) and the shared
    experts' columns, forms their part of the output and
    ``reduce_from_model`` sums the parts.  The tokens and the gate weights
    enter through ``copy_to_model``, so the router's gradient is whole on
    every rank; the aux loss is the same on every model rank, counted once.

    Tokens split into groups of ``group_size``; each group routes on its own
    with capacity ceil(Tg * k / E * cf).  A token's slot in an expert is the
    running count over the group's flattened (token, k) order; a token past
    the capacity is clipped to slot cap - 1 with weight 0 and, the dispatch
    tensor being a scatter-max, never takes that slot from its owner."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    g_sz = min(mo.group_size, T)
    if T % g_sz:
        raise ValueError(f"{T} tokens do not split into dispatch groups of {g_sz}")
    G = T // g_sz
    E, K = mo.n_experts, mo.top_k
    cap = int(np.ceil(g_sz * K / E * mo.capacity_factor))

    xt = x.reshape(G, g_sz, d)
    logits = xt.float() @ lw["router"].float()                       # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)               # [G, Tg, K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    onehot = F.one_hot(gate_idx, E)                                  # [G, Tg, K, E]
    flat = onehot.reshape(G, g_sz * K, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(G, g_sz, K, E)
    pos_tk = pos.gather(3, gate_idx[..., None])[..., 0]              # [G, Tg, K]
    within = (pos_tk >= 0) & (pos_tk < cap)
    safe_pos = pos_tk.clamp(0, cap - 1)

    # disp[g, t, e, c] = max over (t's k picks landing on (e, c)) of within
    g_i = torch.arange(G, device=x.device)[:, None, None]
    t_i = torch.arange(g_sz, device=x.device)[None, :, None]
    slot = ((g_i * g_sz + t_i) * E + gate_idx) * cap + safe_pos
    disp = torch.zeros(G * g_sz * E * cap, dtype=x.dtype, device=x.device)
    disp.scatter_reduce_(0, slot.reshape(-1), within.to(x.dtype).reshape(-1), "amax")
    disp = disp.view(G, g_sz, E, cap)

    # this rank's experts [e0, e0 + El): all of them on one rank
    El = lw["e_in"].shape[0]
    e0 = model_group.index * El
    disp = disp[:, :, e0:e0 + El]
    xm = copy_to_model(xt, model_group)
    xs = torch.einsum("gtec,gtd->gecd", disp, xm)
    h = torch.einsum("gecd,edf->gecf", xs, lw["e_in"])
    g = torch.einsum("gecd,edf->gecf", xs, lw["e_gate"])
    h = F.silu(g) * h
    ys = torch.einsum("gecf,efd->gecd", h, lw["e_out"])            # [G, El, cap, d]

    gate_per_slot = torch.einsum("gtk,gtke->gte", copy_to_model(gate_vals, model_group),
                                 onehot[..., e0:e0 + El].to(gate_vals.dtype))
    comb = disp * gate_per_slot[..., None].to(x.dtype)
    out = torch.einsum("gtec,gecd->gtd", comb, ys)

    if mo.n_shared:
        hs = F.silu(xm @ lw["s_gate"]) * (xm @ lw["s_in"])
        out = out + hs @ lw["s_out"]
    out = reduce_from_model(out, model_group)

    # load-balance aux loss (Switch style)
    density = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    router_prob = probs.mean(dim=(0, 1))
    if data_group is not None:
        density = sum_over(density, data_group) / data_group.size
        router_prob = router_prob / data_group.size
    aux = E * torch.sum(density * router_prob)
    return out.reshape(B, S, d), aux


def _dense_ffn(x: torch.Tensor, lw, model_group: AxisGroup = ONE_RANK) -> torch.Tensor:
    """The gated FFN; over ``model_group`` a rank holds its columns of
    ``w_in``, ``w_gate`` and its rows of ``w_out``."""
    x = copy_to_model(x, model_group)
    h = F.silu(x @ lw["w_gate"]) * (x @ lw["w_in"])
    return reduce_from_model(h @ lw["w_out"], model_group)


def _ffn(cfg: LMConfig, lw, x: torch.Tensor, data_group=None,
         model_group: AxisGroup = ONE_RANK) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, lw["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return (x + _dense_ffn(h, lw, model_group),
                torch.zeros((), dtype=torch.float32, device=x.device))
    y, aux = _moe_ffn(h, lw, cfg, data_group, model_group)
    return x + y, aux


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> contiguous [B, n, S, hd]."""
    B, S = t.shape[:2]
    return t.reshape(B, S, n, hd).transpose(1, 2).contiguous()


def _rope_dim(cfg: LMConfig) -> int:
    """The width rope rotates: the head dim, MLA's qk_rope_dim."""
    return cfg.head_dim if cfg.mla is None else cfg.mla.qk_rope_dim


def _mla_qkv(cfg: LMConfig, lw, h: torch.Tensor, cos, sin,
             model_group: AxisGroup = ONE_RANK) -> tuple:
    """MLA's attention inputs over the full sequence: q [B, H, S, nope +
    rope] (its rope part rotated), k [B, H, S, nope + rope] (the up-projected
    latent, then the one rope key every head shares) and v [B, H, S, v_dim],
    each contiguous: K4 takes them as they are.  Over ``model_group`` H is
    the rank's heads (its columns of ``wq``, ``w_uk``, ``w_uv``); the
    latent and the rope key, from the replicated ``w_dkv`` and ``w_krope``,
    enter the rank's heads through ``copy_to_model``."""
    m = cfg.mla
    B, S = h.shape[:2]
    nope = m.qk_nope_dim
    H = lw["wq"].shape[-1] // (nope + m.qk_rope_dim)
    q = _heads(copy_to_model(h, model_group) @ lw["wq"], H, nope + m.qk_rope_dim)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos, sin)], dim=-1)
    c_kv = copy_to_model(h @ lw["w_dkv"], model_group)                 # [B, S, kv_lora]
    k_rope = copy_to_model(_rotate((h @ lw["w_krope"])[:, None], cos, sin),
                           model_group)                                # [B, 1, S, rope]
    k = torch.cat([_heads(c_kv @ lw["w_uk"], H, nope),
                   k_rope.expand(B, H, S, m.qk_rope_dim)], dim=-1)
    return q, k, _heads(c_kv @ lw["w_uv"], H, m.v_dim)


def _kv_columns(cfg: LMConfig, lw, h: torch.Tensor,
                model_group: AxisGroup) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``h @ wk`` and ``h @ wv`` [B, S, n * hd] over the kv heads this rank's
    q heads read, and n.  With ``n_kv_heads`` a multiple of the model
    ranks, a rank's columns are those heads.  Otherwise a kv head's columns
    lie over several ranks: the columns are gathered over the model ranks
    (before ``rope``, which rotates a head's two halves against each other)
    and the heads of the rank's block of q heads taken."""
    hk, hv = h @ lw["wk"], h @ lw["wv"]
    tp, Hkv = model_group.size, cfg.n_kv_heads
    if Hkv % tp == 0:
        return hk, hv, Hkv // tp
    hq, g = cfg.n_heads // tp, cfg.n_heads // Hkv
    if hq % g and g % hq:
        raise ValueError(f"{cfg.n_heads} q heads over {tp} model ranks straddle the "
                         f"{Hkv} kv heads")
    n, hd = max(hq // g, 1), cfg.head_dim
    lo = (model_group.index * hq // g) * hd
    return (gather_from_model(hk, model_group)[..., lo:lo + n * hd],
            gather_from_model(hv, model_group)[..., lo:lo + n * hd], n)


def _layer(cfg: LMConfig, lw, x: torch.Tensor, cos, sin, data_group=None,
           model_group: AxisGroup = ONE_RANK) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block over the full sequence; attention through K4.
    ``data_group``: the MoE's aux over a data group's batch (``_moe_ffn``).
    ``model_group``: tensor parallelism, K4 over the rank's q heads (a
    contiguous block of ``n_heads / size``) and the kv heads they read,
    ``wo``'s rows then ``reduce_from_model``."""
    B, S, d = x.shape
    h = rms_norm(x, lw["ln1"], cfg.norm_eps)
    if cfg.mla is None:
        hd = cfg.head_dim
        hm = copy_to_model(h, model_group)
        q = _rotate(_heads(hm @ lw["wq"], lw["wq"].shape[-1] // hd, hd), cos, sin)
        hk, hv, n_kv = _kv_columns(cfg, lw, hm, model_group)
        k = _rotate(_heads(hk, n_kv, hd), cos, sin)
        v = _heads(hv, n_kv, hd)
    else:
        q, k, v = _mla_qkv(cfg, lw, h, cos, sin, model_group)
    attn = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    x = x + reduce_from_model(attn.transpose(1, 2).reshape(B, S, -1) @ lw["wo"], model_group)
    return _ffn(cfg, lw, x, data_group, model_group)


def _layer_weights(params, l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["layers"].items()}


def _hidden(cfg: LMConfig, params, tokens: torch.Tensor, data_group=None,
            model_group: AxisGroup = ONE_RANK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream after the last layer, [B, S, d], and the summed
    aux loss (with ``data_group``, this rank's share of the group's:
    ``_moe_ffn``).  ``params`` are this rank's blocks over ``model_group``
    (``shard_params``); the stream is whole on every model rank.  The
    stacked layer leaves are unbound once, so a backward stacks each leaf's
    gradient once (a select a layer would add a whole [L, ...] zero-filled
    gradient a layer); with ``remat`` and autograd on, each layer is a
    ``torch.utils.checkpoint`` (its activations, and its forward's
    collectives, recomputed in the backward)."""
    B, S = tokens.shape
    x = vocab_parallel_embed(params["embed"], tokens, model_group)
    cos, sin = _angles(torch.arange(S, device=x.device), _rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        lw = {k: v[l] for k, v in layers.items()}
        if remat:
            x, a = checkpoint(_layer, cfg, lw, x, cos, sin, data_group, model_group,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer(cfg, lw, x, cos, sin, data_group, model_group)
        aux = aux + a
    return x, aux


def _logits(cfg: LMConfig, params, x: torch.Tensor,
            model_group: AxisGroup = ONE_RANK) -> torch.Tensor:
    """float32 logits over this rank's block of the vocabulary (the whole
    on one rank)."""
    x = copy_to_model(rms_norm(x, params["final_ln"], cfg.norm_eps), model_group)
    return (x @ params["embed"].T).float()


def forward(cfg: LMConfig, params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: int[B, S] -> (logits float32[B, S, V], aux_loss);
    differentiable in ``params``."""
    x, aux = _hidden(cfg, params, tokens)
    return _logits(cfg, params, x), aux


def lm_loss(cfg: LMConfig, params, batch) -> torch.Tensor:
    """batch: {tokens int[B, S], labels int[B, S]}: the next-token
    cross-entropy over the labels ``>= 0``, plus 0.01 x the aux loss (JAX's
    ``lm_loss``)."""
    logits, aux = forward(cfg, params, batch["tokens"])
    labels = batch["labels"].long()
    mask = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    ce = -torch.where(mask, ll, 0.0).sum() / mask.sum().clamp_min(1)
    return ce + 0.01 * aux


@torch.no_grad()
def prefill(cfg: LMConfig, params, tokens: torch.Tensor,
            model_group: AxisGroup = ONE_RANK) -> torch.Tensor:
    """Prefill = the full forward over the prompt; returns the last
    position's logits [B, 1, V].  Only that position goes through the final
    norm and the vocabulary product (the JAX package computes every
    position's and slices).  Over ``model_group`` (``params`` this rank's
    blocks) the ranks' vocabulary blocks of that position are all-gathered,
    the same [B, 1, V] on every rank."""
    x, _ = _hidden(cfg, params, tokens, model_group=model_group)
    return gather_from_model(_logits(cfg, params, x[:, -1:], model_group), model_group)


# ---------------------------------------------------------------------------
# decode / serve path
# ---------------------------------------------------------------------------

def cache_split(cfg: LMConfig, tp: int) -> Optional[str]:
    """The cache dimension split over ``tp`` model ranks, JAX's choice
    (``configs.lm_cells._cache_pspecs`` places the cache by it): ``"heads"``
    (GQA's kv heads, where ``tp`` divides them), else ``"head_dim"`` (where
    it divides the head width), MLA's ``"kv_lora"`` (where it divides the
    latent width), or ``None``: the cache whole on every model rank
    (nothing divides)."""
    if cfg.mla is not None:
        return "kv_lora" if cfg.mla.kv_lora % tp == 0 else None
    if cfg.n_kv_heads % tp == 0:
        return "heads"
    return "head_dim" if cfg.head_dim % tp == 0 else None


def _cache_dims(cfg: LMConfig, tp: int) -> Dict[str, Tuple[Optional[int], int]]:
    """Each cache leaf's (dimension split over the model ranks or None,
    sequence dimension)."""
    split = cache_split(cfg, tp)
    if cfg.mla is not None:
        return {"c_kv": (3 if split else None, 2), "k_rope": (None, 2)}
    d = {"heads": 2, "head_dim": 4}.get(split)
    return {"k": (d, 3), "v": (d, 3)}


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda",
               model_group: AxisGroup = ONE_RANK,
               data_group: AxisGroup = ONE_RANK) -> Dict[str, Any]:
    """An empty KV cache in the model dtype, ``pos`` 0 (a Python int): ``k``
    and ``v`` zeros [L, batch, Hkv, max_len, Dh]; MLA's compressed cache
    ``c_kv`` [L, batch, max_len, kv_lora] and ``k_rope`` [L, batch, max_len,
    rope].  ``batch`` is this rank's rows.  Over ``model_group`` the rank's
    block of the dimension ``cache_split`` names (kv heads, ``head_dim`` or
    ``kv_lora``); over ``data_group`` its block of ``max_len / size``
    positions (the sequence split, where the batch is smaller than the data
    ranks), rank i positions ``[i T, (i + 1) T)``."""
    from repro_torch.configs.cell import UnevenShard

    dev = resolve_device(device)
    if max_len % data_group.size:
        raise UnevenShard(f"a cache of {max_len} positions does not split over "
                          f"{data_group.size} data ranks")
    whole = _whole_cache_shapes(cfg, batch, max_len)
    out: Dict[str, Any] = {}
    for key, (md, sd) in _cache_dims(cfg, model_group.size).items():
        shape = list(whole[key])
        shape[sd] //= data_group.size
        if md is not None:
            shape[md] //= model_group.size
        out[key] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    out["pos"] = 0
    return out


def _whole_cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, tuple]:
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": (L, batch, max_len, m.kv_lora),
                "k_rope": (L, batch, max_len, m.qk_rope_dim)}
    shape = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": shape, "v": shape}


def shard_cache(cfg: LMConfig, cache, model_group: AxisGroup = ONE_RANK,
                data_group: AxisGroup = ONE_RANK) -> Dict[str, Any]:
    """This rank's blocks (copies) of a whole cache (``init_cache``'s on
    one rank, or ``gather_cache``'s), placed as ``init_cache`` places a
    cache over the two groups; ``pos`` as it is."""
    out: Dict[str, Any] = {"pos": cache["pos"]}
    for key, (md, sd) in _cache_dims(cfg, model_group.size).items():
        x = cache[key]
        for d, ag in ((md, model_group), (sd, data_group)):
            if d is not None and ag.size > 1:
                n = x.shape[d] // ag.size
                x = x.narrow(d, ag.index * n, n)
        out[key] = x.clone()
    return out


def gather_cache(cfg: LMConfig, local, model_group: AxisGroup = ONE_RANK,
                 data_group: AxisGroup = ONE_RANK) -> Dict[str, Any]:
    """The whole cache from every rank's blocks (``shard_cache``'s
    inverse): one ``all_gather_into_tensor`` a leaf over each group that
    splits it.  Collective over both groups."""
    out: Dict[str, Any] = {"pos": local["pos"]}
    for key, (md, sd) in _cache_dims(cfg, model_group.size).items():
        x = local[key]
        for d, ag in ((md, model_group), (sd, data_group)):
            if d is not None and ag.size > 1:
                x = gather_rows(x.movedim(d, 0).contiguous(), ag).movedim(0, d).contiguous()
        out[key] = x
    return out


def _key_range(pos: int, window, T: int, seq_group: AxisGroup) -> Tuple[int, int, int]:
    """(base, a, n) of this rank's block of ``T`` positions ``[base, base +
    T)`` (the sequence split over ``seq_group``): the attention at ``pos``
    keeps its keys ``[a, n)``, the filled prefix ``n`` less the keys before
    the window ``[pos - window + 1, pos]``; ``a == n`` where it keeps none."""
    base = seq_group.index * T
    n = min(max(pos + 1 - base, 0), T)
    lo = 0 if window is None else pos - window + 1
    return base, min(max(lo - base, 0), n), n


def _write_row(cache: torch.Tensor, row: torch.Tensor, pos: int, base: int, dim: int) -> None:
    """The new row at global position ``pos`` into this rank's block of the
    sequence (``dim``) starting at ``base``, where the block holds it."""
    if base <= pos < base + cache.shape[dim]:
        cache.narrow(dim, pos - base, 1).copy_(row)


def _decode_layer(cfg: LMConfig, lw, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  pos: int, cos, sin, model_group: AxisGroup = ONE_RANK,
                  seq_group: AxisGroup = ONE_RANK) -> torch.Tensor:
    """One block for a single new token at position ``pos``. x: [B, 1, d];
    ck, cv: this layer's [B, Hkv, T, Dh] cache, this rank's block of it
    (``init_cache``), written in place at ``pos``.  The attention keeps keys
    ``[0, pos]`` and, with a window, the last ``window`` of them: JAX's
    sliding-window slice.

    Split by kv heads (or on one model rank) K4 attends over the rank's q
    heads and the kv heads they read.  Otherwise every head's query and
    the new key and value rows are gathered whole over the model ranks (the
    rows are rotated whole: ``rope`` turns a head's two halves against each
    other): over a cache split along ``head_dim`` each rank forms the
    partial logits of its slice of the width, summed over the model ranks
    (``split_softmax.sum_scores``) before the softmax, its slice of every
    head's output, gathered whole; over a cache whole on every model rank K4
    attends over every head.  A rank keeps its own heads' outputs for
    ``wo``'s rows.  Over ``seq_group`` (the cache split along its sequence)
    each rank attends over its keys, K4 keeping each row's log-sum-exp, and
    ``split_softmax.combine`` merges the ranks' rows; a rank with no key
    kept calls no kernel."""
    B = x.shape[0]
    hd, tp = cfg.head_dim, model_group.size
    split = cache_split(cfg, tp)
    h = copy_to_model(rms_norm(x, lw["ln1"], cfg.norm_eps), model_group)
    hq, hk, hv = h @ lw["wq"], h @ lw["wk"], h @ lw["wv"]
    n_local = hq.shape[-1] // hd          # this rank's q heads
    if tp > 1 and split != "heads":       # every head whole on every model rank
        hq, hk, hv = (gather_from_model(t, model_group) for t in (hq, hk, hv))
    q = _rotate(_heads(hq, hq.shape[-1] // hd, hd), cos, sin)
    k_new = _rotate(_heads(hk, hk.shape[-1] // hd, hd), cos, sin)
    v_new = _heads(hv, hv.shape[-1] // hd, hd)
    dims = slice(0, hd)
    if split == "head_dim":
        w = hd // tp
        dims = slice(model_group.index * w, (model_group.index + 1) * w)
    base, a, n = _key_range(pos, cfg.window, ck.shape[2], seq_group)
    _write_row(ck, k_new[..., dims], pos, base, 2)
    _write_row(cv, v_new[..., dims], pos, base, 2)
    if split == "head_dim":
        attn = _head_dim_attention(q[..., dims], ck[:, :, a:n], cv[:, :, a:n], hd,
                                   model_group, seq_group, x.dtype)
    elif seq_group.size == 1:
        attn = ops.flash_attention(q, ck, cv, causal=True, window=cfg.window, kv_len=pos + 1)
    else:
        if n > a:
            o, lse = ops.flash_attention(q, ck, cv, causal=True, window=None if a == 0 else n - a,
                                         kv_len=n, return_lse=True)
        else:   # no key of this rank is kept: no kernel, weight 0 in the combine
            o = q.new_zeros(q.shape)
            lse = torch.full(q.shape[:3], math.inf, device=q.device)
        attn = split_softmax.combine(o, lse, seq_group).to(x.dtype)
    if attn.shape[1] != n_local:          # this rank's heads of every head's output
        attn = attn[:, model_group.index * n_local:(model_group.index + 1) * n_local]
    x = x + reduce_from_model(attn.transpose(1, 2).reshape(B, 1, -1) @ lw["wo"], model_group)
    return _ffn(cfg, lw, x, model_group=model_group)[0]


def _head_dim_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hd: int,
                        model_group: AxisGroup, seq_group: AxisGroup, dtype) -> torch.Tensor:
    """Attention over a cache split along ``head_dim``, in plain torch (the
    JAX package runs this step in XLA, not Pallas; K4 needs whole heads).
    q [B, Hq, 1, w]: every head's query, this rank's slice of the width; k,
    v [B, Hkv, t, w]: this rank's kept keys (``t`` may be 0).  The partial
    logits in float32, summed over ``model_group``, scaled by ``1/sqrt(hd)``,
    the softmax over the rank's keys merged over ``seq_group``, the output
    slices gathered whole over ``model_group`` -> [B, Hq, 1, hd]."""
    B, Hq, S, w = q.shape
    Hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, w).float()
    logits = torch.einsum("bkrsd,bktd->bkrst", qg, k.float())
    if t:   # the same on every model rank: they hold the same positions
        logits = split_softmax.sum_scores(logits, model_group)
    out, lse = split_softmax.local_attention(logits * (1.0 / math.sqrt(hd)), v[:, :, None])
    out = split_softmax.combine(out, lse, seq_group).to(dtype)
    return gather_from_model(out.reshape(B, Hq, S, w), model_group)


def _decode_layer_mla(cfg: LMConfig, lw, x: torch.Tensor, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, pos: int, cos, sin,
                      model_group: AxisGroup = ONE_RANK,
                      seq_group: AxisGroup = ONE_RANK) -> torch.Tensor:
    """MLA's block for a single new token at position ``pos``, JAX's absorbed
    attention. x: [B, 1, d]; c_kv [B, T, kv_lora] and k_rope [B, T, rope]:
    this layer's compressed cache, this rank's block of it (``init_cache``),
    written in place at ``pos``.  W_uk folds into the query and W_uv into
    the context, so the logits and the context are float32 einsums over the
    filled latent prefix (a view: JAX masks the whole cache instead, the
    same softmax).  No kernel: the JAX package runs this step in none.

    Over ``model_group`` a rank holds its heads' columns of ``wq``, ``w_uk``
    and ``w_uv``; the new latent and rope rows, from the replicated
    ``w_dkv`` and ``w_krope``, are whole on every rank.  Over a cache split
    along ``kv_lora`` a rank gathers every head's latent and rope query
    over the model ranks, forms the logits of its slice of the latent width
    (summed over the model ranks, the rope term added once after), its slice
    of every head's context (gathered whole), and keeps its heads'.  Over
    ``seq_group`` the softmax over the rank's positions is merged by
    ``split_softmax.combine``."""
    m = cfg.mla
    B, nope = x.shape[0], m.qk_nope_dim
    H = lw["wq"].shape[-1] // (nope + m.qk_rope_dim)           # this rank's heads
    split = cache_split(cfg, model_group.size) == "kv_lora"
    h = copy_to_model(rms_norm(x, lw["ln1"], cfg.norm_eps), model_group)
    q = _heads(h @ lw["wq"], H, nope + m.qk_rope_dim)               # [B, H, 1, qk]
    q_nope, q_rope = q[..., :nope], _rotate(q[..., nope:], cos, sin)
    kl = c_kv.shape[-1]
    lat = slice(model_group.index * kl, (model_group.index + 1) * kl) if split else slice(0, kl)
    base, _, n = _key_range(pos, None, c_kv.shape[1], seq_group)
    _write_row(c_kv, (h @ lw["w_dkv"])[..., lat], pos, base, 1)
    _write_row(k_rope, _rotate(h @ lw["w_krope"], cos, sin), pos, base, 1)
    c, kr = c_kv[:, :n].float(), k_rope[:, :n].float()
    q_lat = torch.einsum("bhsd,khd->bhsk", q_nope, lw["w_uk"].view(m.kv_lora, H, nope))
    if split:   # every head, this rank's slice of the latent width
        q_lat = gather_from_model(q_lat, model_group, dim=1)[..., lat]
        q_rope = gather_from_model(q_rope, model_group, dim=1)
    logits = torch.einsum("bhsk,btk->bhst", q_lat.float(), c)
    if split and n:   # the same on every model rank: they hold the same positions
        logits = split_softmax.sum_scores(logits, model_group)
    logits = logits + torch.einsum("bhsd,btd->bhst", q_rope.float(), kr)
    logits *= 1.0 / np.sqrt(nope + m.qk_rope_dim)
    ctx, lse = split_softmax.local_attention(logits, c[:, None])
    ctx = split_softmax.combine(ctx, lse, seq_group)
    if split:   # the whole latent width, this rank's heads
        ctx = gather_from_model(ctx, model_group)[:, model_group.index * H:
                                                  (model_group.index + 1) * H]
    w_uv = lw["w_uv"].view(m.kv_lora, H, m.v_dim).float()
    attn = torch.einsum("bhsk,khd->bhsd", ctx, w_uv).to(x.dtype)
    x = x + reduce_from_model(attn.transpose(1, 2).reshape(B, 1, H * m.v_dim) @ lw["wo"],
                              model_group)
    return _ffn(cfg, lw, x, model_group=model_group)[0]


@torch.no_grad()
def decode_step(cfg: LMConfig, params, cache: Dict[str, Any], tokens: torch.Tensor,
                model_group: AxisGroup = ONE_RANK, data_group: AxisGroup = ONE_RANK):
    """One-token decode. tokens: int[B, 1] -> (logits float32[B, 1, V],
    cache).  The new keys and values are written into ``cache`` in place and
    ``cache["pos"]`` advances by one; the cache returned is the one given.
    Over ``model_group`` (``params`` this rank's blocks, ``cache`` its block
    of the dimension ``cache_split`` names: ``init_cache``) each rank
    attends over its heads and the logits' vocabulary blocks are
    all-gathered, the same on every rank.  ``data_group``: the ranks over
    which the cache is split along its sequence (JAX's placement where the
    batch is smaller than the data ranks), every one given the same
    ``tokens``; where the batch is split instead, each rank steps alone on
    its rows and its cache (the default, one rank)."""
    pos = int(cache["pos"])
    mla = cfg.mla is not None
    max_len = (cache["c_kv"].shape[2] if mla else cache["k"].shape[3]) * data_group.size
    if pos >= max_len:
        raise ValueError(f"the cache is full: pos {pos} of max_len {max_len}")
    x = vocab_parallel_embed(params["embed"], tokens, model_group)
    cos, sin = _angles(torch.arange(pos, pos + 1, device=x.device), _rope_dim(cfg),
                       cfg.rope_theta)
    for l in range(cfg.n_layers):
        lw = _layer_weights(params, l)
        if mla:
            x = _decode_layer_mla(cfg, lw, x, cache["c_kv"][l], cache["k_rope"][l], pos, cos, sin,
                                  model_group, data_group)
        else:
            x = _decode_layer(cfg, lw, x, cache["k"][l], cache["v"][l], pos, cos, sin,
                              model_group, data_group)
    cache["pos"] = pos + 1
    return gather_from_model(_logits(cfg, params, x, model_group), model_group), cache
