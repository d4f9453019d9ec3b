"""Crash-safe dynamic oracle: WAL-logged updates + publish-boundary snapshots.

``DurableDynamicOracle`` wraps the in-memory ``DynamicOracle`` with the
standard database recovery contract:

  * every accepted edge update is appended (fsync'd) to a write-ahead log
    BEFORE it mutates in-memory state — an acknowledged update survives any
    crash,
  * every ``publish`` writes a checksummed snapshot of the full oracle state
    (labels + condensation + levels) through ``repro_torch.persist`` and then
    drops a publish marker into the WAL,
  * ``recover(state_dir)`` = newest verifiable snapshot + WAL replay of the
    records past it, re-publishing at each replayed marker and once more
    for any unpublished tail — so recovery serves every acknowledged
    update and its verdicts agree with a fresh rebuild of the final graph.

Snapshots restore WITHOUT a rebuild: they are taken only at publish
boundaries, where the working label rows equal the published oracle's rows,
and the condensation is serialized exactly (``CondensationState.to_arrays``)
because a fresh Tarjan pass could assign different comp ids than the
incrementally maintained ones the saved labels are written in.

The counterpart of ``repro.dynamic.durable``.  The snapshot's arrays and
meta and the WAL are ``repro``'s byte for byte, so a state dir written by
either package recovers in the other.  ``recover`` takes ``device`` (default
``"cuda"``) for the engine and the epochs it serves.
"""
from __future__ import annotations

import os
import re
import shutil
import warnings
from collections import OrderedDict
from typing import List

import numpy as np

from repro_torch.core.oracle import ReachabilityOracle
from repro_torch.device import resolve_device
from repro_torch.dynamic.delta import CondensationState, EdgeUpdate, UpdateBatch
from repro_torch.dynamic.repair import MutableLabels
from repro_torch.dynamic.versioned import DynamicOracle
from repro_torch.graph.csr import CSRGraph
from repro_torch.persist.blocks import CorruptSnapshotError, load_blocks, save_blocks
from repro_torch.persist.wal import KIND_DELETE, KIND_INSERT, WriteAheadLog
from repro_torch.serve.engine import QueryEngine

_SNAP_RE = re.compile(r"^snap_(\d{8})$")
_WAL_NAME = "wal.bin"


class DurableDynamicOracle(DynamicOracle):
    """``DynamicOracle`` + durability (see module docstring).

    ``state_dir`` holds the WAL (``wal.bin``) and the last
    ``snapshot_keep`` publish snapshots (``snap_<epoch>``)."""

    def __init__(self, g: CSRGraph, state_dir: str, snapshot_keep: int = 2,
                 **kwargs):
        os.makedirs(state_dir, exist_ok=True)
        self.state_dir = state_dir
        self.snapshot_keep = max(int(snapshot_keep), 1)
        self._replaying = False
        super().__init__(g, **kwargs)
        self.wal = WriteAheadLog(os.path.join(state_dir, _WAL_NAME))
        self._snapshot_state()
        self.wal.publish_marker(self._epoch)

    # ------------------------------------------------------------ durability

    def apply(self, batch: UpdateBatch):
        """WAL first, memory second: an update is acknowledged only once it
        is durable, so a crash can lose at most unacknowledged work."""
        if not self._replaying:
            for up in batch.updates:
                self.wal.append(KIND_INSERT if up.insert else KIND_DELETE,
                                up.u, up.v)
        return super().apply(batch)

    def publish(self) -> int:
        ep = super().publish()
        # crash windows: after the (transactional, in-memory) publish but
        # before the snapshot -> recovery replays the WAL tail onto the
        # previous snapshot; after the snapshot but before the marker ->
        # the snapshot's recorded wal_seq already covers everything and the
        # marker is simply rewritten at the next publish
        self._snapshot_state()
        self.wal.publish_marker(ep)
        return ep

    def _snapshot_state(self) -> None:
        d_arr, d_meta = self.delta.to_arrays()
        o = self._base_oracle
        arrays = {f"delta_{k}": v for k, v in d_arr.items()}
        arrays.update(
            L_out=o.L_out, L_in=o.L_in, out_len=o.out_len, in_len=o.in_len,
            hop_rank=o.hop_rank, level=np.asarray(self.level, dtype=np.int32),
        )
        meta = {
            "kind": "DurableDynamicOracle",
            "delta": d_meta,
            "epoch": int(self._epoch),
            "churn": int(self._churn),
            "wal_seq": int(self.wal.last_seq),
            "rebuild_count": int(self.rebuild_count),
            "repair_count": int(self.repair_count),
            "last_ints": int(self._last_ints),
        }
        save_blocks(os.path.join(self.state_dir, f"snap_{self._epoch:08d}"),
                    arrays, meta)
        self._gc_snapshots()

    def _gc_snapshots(self) -> None:
        names = sorted(d for d in os.listdir(self.state_dir) if _SNAP_RE.match(d))
        for stale in names[: -self.snapshot_keep]:
            shutil.rmtree(os.path.join(self.state_dir, stale),
                          ignore_errors=True)

    # -------------------------------------------------------------- recovery

    @classmethod
    def recover(cls, state_dir: str, backend: str = "auto", mesh=None,
                bucketing: bool = True, staleness_budget: float = 0.5,
                max_cone_frac: float = 0.1, keep_epochs: int = 4,
                build_impl: str = "auto", device="cuda") -> "DurableDynamicOracle":
        """Restore from ``state_dir``: newest verifiable snapshot + WAL
        replay.  Raises ``CorruptSnapshotError`` when no snapshot passes
        verification (loud failure — a silently empty oracle would serve
        wrong verdicts)."""
        device = resolve_device(device)
        names = sorted((d for d in os.listdir(state_dir) if _SNAP_RE.match(d)),
                       reverse=True)
        arrays = meta = None
        for name in names:
            spath = os.path.join(state_dir, name)
            try:
                arrays, meta, _ = load_blocks(spath, strict=True)
                break
            except CorruptSnapshotError as e:
                warnings.warn(f"skipping unusable snapshot {spath}: {e}",
                              stacklevel=2)
        if arrays is None:
            raise CorruptSnapshotError(
                f"no verifiable snapshot in {state_dir} "
                f"(found {len(names)}, all corrupt or none present)")

        self = object.__new__(cls)
        self.state_dir = state_dir
        self.snapshot_keep = 2
        self._replaying = False
        self.staleness_budget = float(staleness_budget)
        self.max_cone_frac = float(max_cone_frac)
        self.keep_epochs = int(keep_epochs)
        self.build_impl = build_impl
        self.device = device
        self.delta = CondensationState.from_arrays(
            {k[len("delta_"):]: v for k, v in arrays.items()
             if k.startswith("delta_")},
            meta["delta"])
        oracle = ReachabilityOracle(
            L_out=np.ascontiguousarray(arrays["L_out"], dtype=np.int32),
            L_in=np.ascontiguousarray(arrays["L_in"], dtype=np.int32),
            out_len=np.ascontiguousarray(arrays["out_len"], dtype=np.int32),
            in_len=np.ascontiguousarray(arrays["in_len"], dtype=np.int32),
            hop_rank=np.ascontiguousarray(arrays["hop_rank"], dtype=np.int32),
        )
        # no rebuild: the snapshot was taken at a publish boundary, where the
        # working rows equal the published oracle's rows exactly
        self.hop_rank = oracle.hop_rank
        self.inv_rank = np.argsort(self.hop_rank).astype(np.int32)
        self.labels = MutableLabels.from_oracle(oracle)
        self.level = np.ascontiguousarray(arrays["level"], dtype=np.int32)
        self._base_oracle = oracle
        self._rebuild_pending = False  # publish boundaries never carry one
        self._churn = int(meta["churn"])
        self.rebuild_count = int(meta["rebuild_count"])
        self.repair_count = int(meta["repair_count"])
        self.growth_log: List[dict] = []
        self._last_ints = int(meta["last_ints"])
        self._epochs = OrderedDict()
        self._epoch = int(meta["epoch"])
        self._install_epoch(oracle)
        self.engine = QueryEngine(
            oracle, backend=backend, mesh=mesh, bucketing=bucketing,
            level=self.level, comp_source=self._current_comp,
            epoch=self._epoch, fallback_graph=self.delta.dag_csr(),
            device=device,
        )

        self.wal = WriteAheadLog(os.path.join(state_dir, _WAL_NAME))
        tail = self.wal.replay(after_seq=int(meta["wal_seq"]))
        self.recovered_records = len(tail)
        self._replaying = True
        try:
            pending: List[EdgeUpdate] = []
            for rec in tail:
                if rec.is_publish:
                    if pending:  # a marker with no tail is already covered
                        self.apply(UpdateBatch(tuple(pending)))
                        pending = []
                        self.publish()
                else:
                    pending.append(
                        EdgeUpdate(rec.kind == KIND_INSERT, rec.u, rec.v))
            if pending:
                # acknowledged (WAL-durable) but never published before the
                # crash: recovery publishes them so they are served
                self.apply(UpdateBatch(tuple(pending)))
                self.publish()
        finally:
            self._replaying = False
        return self
