"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: 40L d=2048 32H
(GQA kv=8) d_ff=8192 vocab=49155 (padded to 49408 for TP divisibility —
Megatron-style vocab padding; logits over pad ids are never selected by
data with labels < 49155).  The port of ``repro.configs.granite_3_2b``
(``cells`` waits for the dry-run port)."""
from __future__ import annotations

import torch

from repro_torch.configs.lm_cells import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "granite-3-2b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
VOCAB_REAL = 49155


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49408,  # padded from 49155 (divisible by 256)
        dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=128,
        dtype=torch.float32,
        remat=False,
    )
