"""Verified persistence of the port (the counterpart of ``repro.persist``;
every on-disk format is the JAX package's byte for byte, so a file written by
either package loads in the other).

  * ``blocks`` — the storage primitive: a directory of named array blocks,
    CRC32 per block + a manifest hash over the block table, written
    temp-then-rename so a crash mid-save never corrupts the previous
    snapshot.  Loads verify every checksum; ``strict=False`` quarantines
    bad blocks instead of raising.
  * ``oracle_io`` — checksummed save/load of ``ReachabilityOracle``
    snapshots and budget-truncated stores (label matrices split into row
    blocks so corruption quarantines a block of rows, not the whole index).
  * ``wal`` — the write-ahead log for dynamic edge updates: fixed-width
    CRC-framed records, torn-tail truncation on replay, seq-addressed so
    recovery replays exactly the records after the last snapshot.

The construction engine's wave-granular checkpoints
(``repro_torch.build.engine``), cold start (``core.api.oracle_from_snapshot``)
and the budget governor's snapshot reload (``serve.budget``) are its
consumers, with ``LabelEpoch`` snapshots and the WAL's consumer, the
durable dynamic oracle (``repro_torch.dynamic.durable``).
"""
from repro_torch.persist.blocks import (
    CorruptSnapshotError,
    load_blocks,
    pack_ragged,
    save_blocks,
    snapshot_meta,
    unpack_ragged,
)
from repro_torch.persist.oracle_io import (
    LoadReport,
    load_budgeted,
    load_epoch,
    load_oracle,
    save_budgeted,
    save_epoch,
    save_oracle,
)
from repro_torch.persist.wal import WalRecord, WriteAheadLog

__all__ = [
    "CorruptSnapshotError",
    "save_blocks",
    "load_blocks",
    "snapshot_meta",
    "pack_ragged",
    "unpack_ragged",
    "save_oracle",
    "load_oracle",
    "save_epoch",
    "load_epoch",
    "save_budgeted",
    "load_budgeted",
    "LoadReport",
    "WriteAheadLog",
    "WalRecord",
]
