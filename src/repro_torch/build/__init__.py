"""Construction engine of the port.

  * ``engine``         — Distribution-Labeling construction with pluggable
                         implementations: the scalar path
                         (``impl="reference"``), the host wave-scheduled
                         bit-parallel path (``impl="wave"``), the host
                         optimistic-chunk path (``impl="speculative"``), the
                         device wave engine (``impl="device"``), and the
                         host engines' build checkpoints.
  * ``waves``          — the wave schedulers (exact and speculative).
  * ``bitset``         — packed uint64/uint32 bitset utilities + the ELL slab
                         builder shared by the host and device engines.
  * ``traverse``       — the scalar pruned BFS of the reference engine.
  * ``engine_device``  — the device wave engine (K2's frontier form a BFS
                         level, on-device label append).
"""
from repro_torch.build.engine import build_distribution_labels
from repro_torch.build.waves import wave_schedule

__all__ = ["build_distribution_labels", "wave_schedule"]
