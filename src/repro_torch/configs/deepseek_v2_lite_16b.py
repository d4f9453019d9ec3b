"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d=2048 16H, MLA
(kv_lora=512, qk_nope 128, qk_rope 64, v 128), MoE: 64 routed experts top-6
+ 2 shared, expert d_ff=1408, vocab=102400.

The port of ``repro.configs.deepseek_v2_lite_16b``, as data: the port's
model raises ``NotImplementedError`` for MLA until K4 takes its widths
(ROADMAP.md Queue 1, item 12).  ``cells`` waits for the dry-run port.

NOTE on the assignment line: the bracket spec says "MoE 64e top-6" while the
comment says "160 routed" (that is full V2, not Lite). We follow the
structured spec + the published V2-Lite card: 64 routed + 2 shared, top-6.
"""
from __future__ import annotations

import torch

from repro_torch.configs.lm_cells import LM_SHAPES
from repro_torch.models.transformer import LMConfig, MLACfg, MoECfg

ARCH_ID = "deepseek-v2-lite-16b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        vocab=102400,
        mla=MLACfg(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        moe=MoECfg(
            n_experts=64, top_k=6, d_ff_expert=1408,
            n_shared=2, d_ff_shared=1408, capacity_factor=1.25, group_size=1024,
        ),
        dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=128,
        mla=MLACfg(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                   d_ff_shared=32, capacity_factor=4.0, group_size=32),
        dtype=torch.float32,
        remat=False,
    )
