"""deepseek-7b [arXiv:2401.02954; hf]: 30L d=4096 32H (GQA kv=32 = MHA)
d_ff=11008 vocab=102400 — llama-architecture.  The port of
``repro.configs.deepseek_7b``."""
from __future__ import annotations

import torch

from repro_torch.configs.lm_cells import LM_SHAPES, lm_cell
from repro_torch.models.transformer import LMConfig

ARCH_ID = "deepseek-7b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
        dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=128,
        dtype=torch.float32,
        remat=False,
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    return lm_cell(
        full_config(), ARCH_ID, shape, mesh, variant,
        accum_micro_per_device=1, sub_quadratic=False,
    )
