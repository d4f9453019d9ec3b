"""The LM family's shapes (the assignment's), the port of
``repro.configs.lm_cells.LM_SHAPES``:

  train_4k     seq 4,096   global_batch 256   -> train step (not ported yet)
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   cache 32,768 global_batch 128  -> decode_step
  long_500k    cache 524,288 global_batch 1   -> decode_step; only for
               sub-quadratic archs (SWA)

``lm_cell`` and the step builders lower JAX cells for the dry run; they
wait for the dry-run port (ROADMAP.md Queue 1, item 12).
"""
from __future__ import annotations

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
