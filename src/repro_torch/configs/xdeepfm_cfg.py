"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, MLP 400-400.  The port of ``repro.configs.xdeepfm_cfg``
(``cells`` waits for the dry-run port; the train step for the training
port).

Shapes:
  train_batch    B=65,536    train step (not ported yet)
  serve_p99      B=512       forward (online inference)
  serve_bulk     B=262,144   forward (offline scoring)
  retrieval_cand B=1, C=1,000,000  candidate scoring in chunks of 25,000
"""
from __future__ import annotations

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
