"""h2o-danube-1.8b [arXiv:2401.16818; hf]: 24L d=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000 — llama+mistral mix with sliding-window attention
(Mistral-style window 4096). SWA makes it sub-quadratic -> long_500k runs.
The port of ``repro.configs.h2o_danube_1_8b``."""
from __future__ import annotations

import torch

from repro_torch.configs.lm_cells import LM_SHAPES, lm_cell
from repro_torch.models.transformer import LMConfig

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID,
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        window=4096,
        rope_theta=10000.0,
        dtype=torch.bfloat16,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=128,
        window=32,
        dtype=torch.float32,
        remat=False,
    )


def cells(shape: str, mesh, variant: str = "baseline"):
    return lm_cell(
        full_config(), ARCH_ID, shape, mesh, variant,
        accum_micro_per_device=2, sub_quadratic=True,
    )
