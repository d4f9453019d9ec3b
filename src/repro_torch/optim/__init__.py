"""The optimizer of the port's training path (``repro.optim``'s AdamW).
``quantized_psum_grads`` (the int8 all-reduce) waits for the multi-device
half of training (ROADMAP.md Queue 1)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                                     global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]
