"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L
d=1024 16H (GQA kv=8) expert d_ff=512, 32 experts top-8, vocab=49155
(padded to 49408 for TP divisibility).  The port of
``repro.configs.granite_moe_1b_a400m``."""
from __future__ import annotations

import torch

from repro_torch.configs.lm_cells import LM_SHAPES, lm_cell
from repro_torch.models.transformer import LMConfig, MoECfg

ARCH_ID = "granite-moe-1b-a400m"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
VOCAB_REAL = 49155


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=0,
        vocab=49408,  # padded from 49155
        moe=MoECfg(n_experts=32, top_k=8, d_ff_expert=512,
                   capacity_factor=1.25, group_size=1024),
        dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab=128,
        moe=MoECfg(n_experts=8, top_k=4, d_ff_expert=32,
                   capacity_factor=4.0, group_size=32),
        dtype=torch.float32,
        remat=False,
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    return lm_cell(
        full_config(), ARCH_ID, shape, mesh, variant,
        accum_micro_per_device=4, sub_quadratic=False,
    )
