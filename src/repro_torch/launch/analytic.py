"""Analytic roofline numerators for LM cells, the port of
``repro.launch.analytic`` over the port's ``LMConfig`` (pure arithmetic, the
same numbers).

WHY: XLA's HloCostAnalysis counts every while-loop body ONCE, so the JAX
package's LM cells (a scanned layer stack, a grad-accumulation scan) carry
these analytic terms.  The port's dry run traces every layer and every
microbatch (``launch.dryrun``), so its trace counts do not undercount; the
LM cells still carry these terms in ``meta["analytic"]`` and the dry run's
roofline takes them where present, as JAX's does, the traced numbers
recorded beside them.

All numbers are PER DEVICE PER STEP. Conventions:
  train FLOPs = 3x forward (fwd 2NT, bwd 4NT)
  causal attention averages T_eff = S/2 keys per query (window caps it)
  bf16 weights/activations (2B), fp32 optimizer (4B)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.transformer import LMConfig


def _attn_dims(cfg: LMConfig):
    if cfg.mla is not None:
        qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        return cfg.n_heads, qk, cfg.mla.v_dim
    return cfg.n_heads, cfg.head_dim, cfg.head_dim


def lm_train_terms(
    cfg: LMConfig, batch: int, seq: int, n_accum: int, dp: int, tp: int
) -> Dict[str, float]:
    tokens = batch * seq
    chips = dp * tp
    n_act = cfg.active_param_count()
    H, dqk, dv = _attn_dims(cfg)

    # ---- compute ----
    t_eff = seq / 2 if cfg.window is None else min(seq / 2, cfg.window)
    attn_fwd = 2 * cfg.n_layers * H * (dqk + dv) * t_eff * tokens  # QK^T + PV
    flops_total = 3 * (2 * n_act * tokens + attn_fwd)
    flops_dev = flops_total / chips

    # ---- memory ----
    pbytes_dev = 2 * cfg.param_count() / tp            # bf16 weights per device
    micro_tokens_dev = tokens / n_accum / dp
    # weights stream fwd+bwd each microstep (3 passes), grads written once
    w_traffic = n_accum * 3 * pbytes_dev + 2 * pbytes_dev
    # optimizer: read+write master/mu/nu fp32 (ZeRO-sharded over chips)
    opt_traffic = 6 * 4 * cfg.param_count() / chips * 2
    # activations: ~12 residual-stream touches per layer with remat (+logits)
    act_traffic = n_accum * (
        12 * micro_tokens_dev * cfg.d_model * cfg.n_layers * 2
        + 2 * micro_tokens_dev * cfg.vocab / tp * 4
    )
    bytes_dev = w_traffic + opt_traffic + act_traffic

    # ---- collectives ----
    # TP: 2 all-reduces per layer fwd + 2 bwd, activation-sized
    tp_coll = 0.0
    if tp > 1:
        tp_coll = n_accum * 4 * cfg.n_layers * micro_tokens_dev * cfg.d_model * 2
    # DP: gradient reduce-scatter + all-gather (bf16, TP-sharded grads)
    dp_coll = 0.0
    if dp > 1:
        dp_coll = 2 * 2 * cfg.param_count() / tp
    # EP: MoE dispatch/combine all-to-all (2x tokens*d each way)
    ep_coll = 0.0
    if cfg.moe is not None and tp > 1:
        ep_coll = n_accum * 2 * cfg.n_layers * 2 * micro_tokens_dev * cfg.d_model * 2
    coll_dev = tp_coll + dp_coll + ep_coll

    return dict(flops=flops_dev, bytes=bytes_dev, coll=coll_dev, model_flops=flops_total)


def lm_prefill_terms(cfg: LMConfig, batch: int, seq: int, dp: int, tp: int) -> Dict[str, float]:
    tokens = batch * seq
    chips = dp * tp
    n_act = cfg.active_param_count()
    H, dqk, dv = _attn_dims(cfg)
    t_eff = seq / 2 if cfg.window is None else min(seq / 2, cfg.window)
    attn_fwd = 2 * cfg.n_layers * H * (dqk + dv) * t_eff * tokens
    flops_total = 2 * n_act * tokens + attn_fwd
    tokens_dev = tokens / dp
    pbytes_dev = 2 * cfg.param_count() / tp
    bytes_dev = (
        pbytes_dev                                   # weights streamed once
        + 8 * tokens_dev * cfg.d_model * cfg.n_layers * 2
        + 2 * tokens_dev * cfg.vocab / tp * 4 / seq  # last-position logits only
    )
    coll_dev = 2 * cfg.n_layers * tokens_dev * cfg.d_model * 2 * (2 if tp > 1 else 0)
    return dict(flops=flops_total / chips, bytes=bytes_dev, coll=coll_dev,
                model_flops=flops_total)


def lm_decode_terms(cfg: LMConfig, batch: int, cache_len: int, dp: int, tp: int) -> Dict[str, float]:
    chips = dp * tp
    n_act = cfg.active_param_count()
    H, dqk, dv = _attn_dims(cfg)
    t_eff = cache_len if cfg.window is None else min(cache_len, cfg.window)
    # per new token: weights matmuls + attention over the cache
    attn = 2 * cfg.n_layers * H * (dqk + dv) * t_eff * batch
    flops_total = 2 * n_act * batch + attn
    # memory: whole weights + cache read dominate (batch tiny)
    pbytes_dev = 2 * cfg.param_count() / tp
    if cfg.mla is not None:
        cache_row = cfg.mla.kv_lora + cfg.mla.qk_rope_dim
        cache_bytes = cfg.n_layers * batch * t_eff * cache_row * 2
    else:
        cache_bytes = cfg.n_layers * batch * t_eff * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    bytes_dev = pbytes_dev + cache_bytes / chips
    coll_dev = (2 * cfg.n_layers * (batch / max(dp, 1)) * cfg.d_model * 2) * (2 if tp > 1 else 0)
    return dict(flops=flops_total / chips, bytes=bytes_dev, coll=coll_dev,
                model_flops=flops_total)
