"""The optimizer of the port's training path (``repro.optim``): AdamW, its
ZeRO-sharded form over a mesh's data group, and the int8 gradient
all-reduce."""
from repro_torch.optim.adamw import (AdamWState, ZeroLayout, adamw_init, adamw_update,
                                     cosine_schedule, global_norm, zero_gather, zero_init,
                                     zero_layout, zero_shard, zero_update)
from repro_torch.optim.compression import quantized_psum_grads

__all__ = ["AdamWState", "ZeroLayout", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "quantized_psum_grads", "zero_gather", "zero_init", "zero_layout",
           "zero_shard", "zero_update"]
