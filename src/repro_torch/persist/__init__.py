"""Verified persistence of the port.

  * ``blocks`` — the storage primitive: a directory of named array blocks,
    CRC32 per block + a manifest hash over the block table, written
    temp-then-rename so a crash mid-save never corrupts the previous
    snapshot.  Loads verify every checksum; ``strict=False`` quarantines
    bad blocks instead of raising.

The construction engine's wave-granular checkpoints
(``repro_torch.build.engine``) are its consumer.  The oracle snapshots
(``oracle_io``) and the write-ahead log (``wal``) of the JAX package are
the next slice of the port (ROADMAP.md Queue 1 item 6).
"""
from repro_torch.persist.blocks import (
    CorruptSnapshotError,
    load_blocks,
    pack_ragged,
    save_blocks,
    snapshot_meta,
    unpack_ragged,
)

__all__ = [
    "CorruptSnapshotError",
    "save_blocks",
    "load_blocks",
    "snapshot_meta",
    "pack_ragged",
    "unpack_ragged",
]
