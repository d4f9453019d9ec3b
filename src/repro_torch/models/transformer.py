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
without a host read a step.  ``forward`` and ``lm_loss`` are differentiable
(K4's autograd Function runs its backward kernel on the card); ``remat``
recomputes each layer in the backward (``torch.utils.checkpoint``, as JAX's
``jax.checkpoint``), and only there.  ``attn_impl``, ``chunk_q``,
``chunk_k`` and ``logical_batch_axes`` are kept so that configs read the
same; they change nothing here.  The cast points are the JAX package's:
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
from repro_torch.kernels import ops
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


def _moe_ffn(x: torch.Tensor, lw, cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped capacity-based one-hot dispatch MoE (GShard-style), JAX's
    ``_moe_ffn``.  x: [B, S, d] -> ([B, S, d], aux load-balance loss).

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

    xs = torch.einsum("gtec,gtd->gecd", disp, xt)
    h = torch.einsum("gecd,edf->gecf", xs, lw["e_in"])
    g = torch.einsum("gecd,edf->gecf", xs, lw["e_gate"])
    h = F.silu(g) * h
    ys = torch.einsum("gecf,efd->gecd", h, lw["e_out"])            # [G, E, cap, d]

    gate_per_slot = torch.einsum("gtk,gtke->gte", gate_vals, onehot.to(gate_vals.dtype))
    comb = disp * gate_per_slot[..., None].to(x.dtype)
    out = torch.einsum("gtec,gecd->gtd", comb, ys)

    if mo.n_shared:
        hs = F.silu(xt @ lw["s_gate"]) * (xt @ lw["s_in"])
        out = out + hs @ lw["s_out"]

    # load-balance aux loss (Switch style)
    density = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    router_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * router_prob)
    return out.reshape(B, S, d), aux


def _dense_ffn(x: torch.Tensor, lw) -> torch.Tensor:
    h = F.silu(x @ lw["w_gate"]) * (x @ lw["w_in"])
    return h @ lw["w_out"]


def _ffn(cfg: LMConfig, lw, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, lw["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + _dense_ffn(h, lw), torch.zeros((), dtype=torch.float32, device=x.device)
    y, aux = _moe_ffn(h, lw, cfg)
    return x + y, aux


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> contiguous [B, n, S, hd]."""
    B, S = t.shape[:2]
    return t.reshape(B, S, n, hd).transpose(1, 2).contiguous()


def _rope_dim(cfg: LMConfig) -> int:
    """The width rope rotates: the head dim, MLA's qk_rope_dim."""
    return cfg.head_dim if cfg.mla is None else cfg.mla.qk_rope_dim


def _mla_qkv(cfg: LMConfig, lw, h: torch.Tensor, cos, sin) -> tuple:
    """MLA's attention inputs over the full sequence: q [B, H, S, nope +
    rope] (its rope part rotated), k [B, H, S, nope + rope] (the up-projected
    latent, then the one rope key every head shares) and v [B, H, S, v_dim],
    each contiguous: K4 takes them as they are."""
    m = cfg.mla
    B, S = h.shape[:2]
    H, nope = cfg.n_heads, m.qk_nope_dim
    q = _heads(h @ lw["wq"], H, nope + m.qk_rope_dim)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos, sin)], dim=-1)
    c_kv = h @ lw["w_dkv"]                                          # [B, S, kv_lora]
    k_rope = _rotate((h @ lw["w_krope"])[:, None], cos, sin)        # [B, 1, S, rope]
    k = torch.cat([_heads(c_kv @ lw["w_uk"], H, nope),
                   k_rope.expand(B, H, S, m.qk_rope_dim)], dim=-1)
    return q, k, _heads(c_kv @ lw["w_uv"], H, m.v_dim)


def _layer(cfg: LMConfig, lw, x: torch.Tensor, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block over the full sequence; attention through K4."""
    B, S, d = x.shape
    h = rms_norm(x, lw["ln1"], cfg.norm_eps)
    if cfg.mla is None:
        hd = cfg.head_dim
        q = _rotate(_heads(h @ lw["wq"], cfg.n_heads, hd), cos, sin)
        k = _rotate(_heads(h @ lw["wk"], cfg.n_kv_heads, hd), cos, sin)
        v = _heads(h @ lw["wv"], cfg.n_kv_heads, hd)
    else:
        q, k, v = _mla_qkv(cfg, lw, h, cos, sin)
    attn = ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    x = x + attn.transpose(1, 2).reshape(B, S, -1) @ lw["wo"]
    return _ffn(cfg, lw, x)


def _layer_weights(params, l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["layers"].items()}


def _hidden(cfg: LMConfig, params, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream after the last layer, [B, S, d], and the summed
    aux loss.  The stacked layer leaves are unbound once, so a backward
    stacks each leaf's gradient once (a select a layer would add a whole
    [L, ...] zero-filled gradient a layer); with ``remat`` and autograd on,
    each layer is a ``torch.utils.checkpoint`` (its activations recomputed
    in the backward)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    cos, sin = _angles(torch.arange(S, device=x.device), _rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        lw = {k: v[l] for k, v in layers.items()}
        if remat:
            x, a = checkpoint(_layer, cfg, lw, x, cos, sin, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _layer(cfg, lw, x, cos, sin)
        aux = aux + a
    return x, aux


def _logits(cfg: LMConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
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
def prefill(cfg: LMConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill = the full forward over the prompt; returns the last
    position's logits [B, 1, V].  Only that position goes through the final
    norm and the vocabulary product (the JAX package computes every
    position's and slices)."""
    x, _ = _hidden(cfg, params, tokens)
    return _logits(cfg, params, x[:, -1:])


# ---------------------------------------------------------------------------
# decode / serve path
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda") -> Dict[str, Any]:
    """An empty KV cache in the model dtype, ``pos`` 0 (a Python int): ``k``
    and ``v`` zeros [L, batch, Hkv, max_len, Dh]; MLA's compressed cache
    ``c_kv`` [L, batch, max_len, kv_lora] and ``k_rope`` [L, batch, max_len,
    rope]."""
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": torch.zeros((L, batch, max_len, m.kv_lora), dtype=cfg.dtype, device=dev),
                "k_rope": torch.zeros((L, batch, max_len, m.qk_rope_dim), dtype=cfg.dtype,
                                      device=dev),
                "pos": 0}
    shape = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": 0}


def _decode_layer(cfg: LMConfig, lw, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  pos: int, cos, sin) -> torch.Tensor:
    """One block for a single new token at position ``pos``. x: [B, 1, d];
    ck, cv: this layer's [B, Hkv, max_len, Dh] cache, written in place at
    ``pos``.  K4 attends over keys [0, pos] (``kv_len = pos + 1``) and, with a
    window, over the last ``window`` of them: JAX's sliding-window slice."""
    B = x.shape[0]
    hd = cfg.head_dim
    h = rms_norm(x, lw["ln1"], cfg.norm_eps)
    q = _rotate(_heads(h @ lw["wq"], cfg.n_heads, hd), cos, sin)
    ck[:, :, pos:pos + 1] = _rotate(_heads(h @ lw["wk"], cfg.n_kv_heads, hd), cos, sin)
    cv[:, :, pos:pos + 1] = _heads(h @ lw["wv"], cfg.n_kv_heads, hd)
    attn = ops.flash_attention(q, ck, cv, causal=True, window=cfg.window, kv_len=pos + 1)
    x = x + attn.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd) @ lw["wo"]
    return _ffn(cfg, lw, x)[0]


def _decode_layer_mla(cfg: LMConfig, lw, x: torch.Tensor, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, pos: int, cos, sin) -> torch.Tensor:
    """MLA's block for a single new token at position ``pos``, JAX's absorbed
    attention. x: [B, 1, d]; c_kv [B, max_len, kv_lora] and k_rope [B,
    max_len, rope]: this layer's compressed cache, written in place at
    ``pos``.  W_uk folds into the query and W_uv into the context, so the
    scores and the context are float32 einsums over the latent prefix
    ``[:pos + 1]`` (a view: JAX masks the whole cache instead, the same
    softmax).  No kernel: the JAX package runs this step in none."""
    m = cfg.mla
    B, H, nope = x.shape[0], cfg.n_heads, m.qk_nope_dim
    h = rms_norm(x, lw["ln1"], cfg.norm_eps)
    q = _heads(h @ lw["wq"], H, nope + m.qk_rope_dim)               # [B, H, 1, qk]
    q_nope, q_rope = q[..., :nope], _rotate(q[..., nope:], cos, sin)
    c_kv[:, pos:pos + 1] = h @ lw["w_dkv"]
    k_rope[:, pos:pos + 1] = _rotate(h @ lw["w_krope"], cos, sin)
    c, kr = c_kv[:, :pos + 1].float(), k_rope[:, :pos + 1].float()
    q_lat = torch.einsum("bhsd,khd->bhsk", q_nope, lw["w_uk"].view(m.kv_lora, H, nope))
    logits = (torch.einsum("bhsk,btk->bhst", q_lat.float(), c)
              + torch.einsum("bhsd,btd->bhst", q_rope.float(), kr))
    logits *= 1.0 / np.sqrt(nope + m.qk_rope_dim)
    ctx = torch.einsum("bhst,btk->bhsk", torch.softmax(logits, dim=-1), c)
    w_uv = lw["w_uv"].view(m.kv_lora, H, m.v_dim).float()
    attn = torch.einsum("bhsk,khd->bhsd", ctx, w_uv).to(x.dtype)
    x = x + attn.transpose(1, 2).reshape(B, 1, H * m.v_dim) @ lw["wo"]
    return _ffn(cfg, lw, x)[0]


@torch.no_grad()
def decode_step(cfg: LMConfig, params, cache: Dict[str, Any], tokens: torch.Tensor):
    """One-token decode. tokens: int[B, 1] -> (logits float32[B, 1, V],
    cache).  The new keys and values are written into ``cache`` in place and
    ``cache["pos"]`` advances by one; the cache returned is the one given."""
    pos = int(cache["pos"])
    mla = cfg.mla is not None
    max_len = cache["c_kv"].shape[2] if mla else cache["k"].shape[3]
    if pos >= max_len:
        raise ValueError(f"the cache is full: pos {pos} of max_len {max_len}")
    x = params["embed"][tokens.long()]
    cos, sin = _angles(torch.arange(pos, pos + 1, device=x.device), _rope_dim(cfg),
                       cfg.rope_theta)
    layer, a, b = ((_decode_layer_mla, "c_kv", "k_rope") if mla else (_decode_layer, "k", "v"))
    for l in range(cfg.n_layers):
        x = layer(cfg, _layer_weights(params, l), x, cache[a][l], cache[b][l], pos, cos, sin)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache
