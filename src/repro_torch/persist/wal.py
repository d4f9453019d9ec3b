"""Write-ahead log for dynamic oracle edge updates.

A copy of ``repro.persist.wal``: the record layout, the CRC and the torn-tail
rule are the same byte for byte, so a log written by either package replays
identically in the other (``tests/test_torch_persist.py``).

Record format (fixed width, little-endian)::

    <B  kind    0=delete edge, 1=insert edge, 2=publish marker
    <q  u       source vertex (publish: the epoch number)
    <q  v       target vertex (publish: unused, -1)
    <q  seq     monotonically increasing sequence number
    <I  crc32   over the 25 payload bytes above

Recovery contract: ``DurableDynamicOracle`` appends every edge update to
the WAL (fsync'd) *before* applying it in memory, and drops a publish
marker right after each successful publish + snapshot.  After a crash,
the oracle = latest snapshot + ``replay(after_seq=snapshot_seq)``.

A torn tail (partial last record from a crash mid-append, or a corrupt
record) truncates the log at the last good record with a warning — records
before the tear are intact because each carries its own CRC.  A corrupt
record *followed by good ones* is different: that is not a torn write but
real corruption, and replay refuses it loudly (``CorruptSnapshotError``)
rather than silently dropping updates from the middle of history.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import warnings
import zlib
from typing import Iterator, List, Optional

from repro_torch.persist.blocks import CorruptSnapshotError

_PAYLOAD = struct.Struct("<Bqqq")
_CRC = struct.Struct("<I")
RECORD_SIZE = _PAYLOAD.size + _CRC.size  # 29 bytes

KIND_DELETE = 0
KIND_INSERT = 1
KIND_PUBLISH = 2


@dataclasses.dataclass(frozen=True)
class WalRecord:
    kind: int
    u: int
    v: int
    seq: int

    @property
    def is_publish(self) -> bool:
        return self.kind == KIND_PUBLISH

    def encode(self) -> bytes:
        payload = _PAYLOAD.pack(self.kind, self.u, self.v, self.seq)
        return payload + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF)

    @classmethod
    def decode(cls, raw: bytes) -> "WalRecord":
        payload, (crc,) = raw[:_PAYLOAD.size], _CRC.unpack(raw[_PAYLOAD.size:])
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError("wal record crc mismatch")
        return cls(*_PAYLOAD.unpack(payload))


class WriteAheadLog:
    """Append-only, CRC-framed, fsync'd edge-update log."""

    def __init__(self, path: str):
        self.path = path
        self.last_seq = -1
        self._f = None
        self._scan()
        self._f = open(self.path, "ab")

    # -------------------------------------------------------------- write

    def append(self, kind: int, u: int, v: int) -> int:
        """Log one record durably (fsync before returning); returns its seq."""
        seq = self.last_seq + 1
        self._f.write(WalRecord(kind, u, v, seq).encode())
        self._f.flush()
        os.fsync(self._f.fileno())
        self.last_seq = seq
        return seq

    def publish_marker(self, epoch: int) -> int:
        """Mark that every record up to here is covered by epoch ``epoch``'s
        snapshot (replay splits batches at these)."""
        return self.append(KIND_PUBLISH, int(epoch), -1)

    def reset(self) -> None:
        """Truncate the log (the snapshot now covers everything)."""
        self._f.close()
        self._f = open(self.path, "wb")
        self.last_seq = -1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # --------------------------------------------------------------- read

    def _scan(self) -> None:
        """Find last_seq on open (tolerating a torn tail)."""
        for rec in self._read(truncate_torn=True):
            self.last_seq = rec.seq

    def _read(self, truncate_torn: bool) -> Iterator[WalRecord]:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        n_full = len(raw) // RECORD_SIZE
        torn_at: Optional[int] = None
        records: List[WalRecord] = []
        for i in range(n_full):
            chunk = raw[i * RECORD_SIZE: (i + 1) * RECORD_SIZE]
            try:
                records.append(WalRecord.decode(chunk))
            except ValueError:
                torn_at = i
                break
        else:
            if len(raw) % RECORD_SIZE:
                torn_at = n_full
        if torn_at is not None:
            # corruption in the middle of history (good records after the bad
            # one) is not a torn write — refuse instead of dropping updates
            tail = raw[(torn_at + 1) * RECORD_SIZE:]
            for j in range(len(tail) // RECORD_SIZE):
                try:
                    WalRecord.decode(tail[j * RECORD_SIZE: (j + 1) * RECORD_SIZE])
                except ValueError:
                    continue
                raise CorruptSnapshotError(
                    f"wal {self.path}: corrupt record #{torn_at} followed by "
                    f"intact records — mid-log corruption, refusing to replay")
            if not truncate_torn:
                raise CorruptSnapshotError(
                    f"wal {self.path}: torn record #{torn_at}")
            warnings.warn(
                f"wal {self.path}: torn tail at record #{torn_at} "
                f"(byte {torn_at * RECORD_SIZE}); truncating", stacklevel=3)
            with open(self.path, "r+b") as f:
                f.truncate(torn_at * RECORD_SIZE)
        yield from records

    def replay(self, after_seq: int = -1) -> List[WalRecord]:
        """All intact records with ``seq > after_seq``, in order (the torn
        tail, if any, is truncated with a warning first)."""
        return [r for r in self._read(truncate_torn=True) if r.seq > after_seq]
