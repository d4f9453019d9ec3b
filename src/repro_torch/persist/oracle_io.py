"""Checksummed save/load of ReachabilityOracle snapshots and budget-truncated
stores.

A copy of ``repro.persist.oracle_io`` (numpy only): snapshot kinds, block
names, the row-block size and the mask layout are the same, so a snapshot
written by either package loads in the other (``tests/test_torch_persist.py``).

Label matrices are split into fixed-size ROW BLOCKS, each with its own
CRC32 (``persist.blocks``), so a corrupt block quarantines the rows it
backs instead of the whole index: ``load_oracle(path, strict=False)``
returns the oracle with those rows zeroed PLUS a ``LoadReport`` whose
``quarantine_out`` / ``quarantine_in`` masks name them — the serve engine
routes queries touching a quarantined row down its degradation ladder
(bounded online search) so corruption degrades throughput, never
correctness.  ``strict=True`` (default) refuses to load at all, with the
checksum diagnostic.

Per-row-block corruption semantics by block kind:

  * ``L_out.<k>`` / ``L_in.<k>`` row blocks -> quarantine those rows,
  * ``out_len`` / ``in_len`` -> the whole side is untrustworthy ->
    quarantine every row of that side,
  * ``hop_rank`` -> only affects ``unrank`` (observability), dropped with
    a warning,
  * a budgeted store's ``trunc_mask_out`` / ``trunc_mask_in`` -> that whole
    side is treated as truncated (all-True mask): truncation marks only
    route misses to the exact-search rung, so over-marking is always safe.

``LabelEpoch`` snapshots (``save_epoch`` / ``load_epoch``) add the epoch's
``comp`` and ``level`` blocks: a corrupt ``comp`` is fatal even when not
strict, a corrupt ``level`` disables the level prefilter.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.persist.blocks import CorruptSnapshotError, load_blocks, save_blocks

ROW_BLOCK = 4096


@dataclasses.dataclass
class LoadReport:
    """What a non-strict load had to quarantine."""
    bad_blocks: List[str]
    quarantine_out: np.ndarray  # bool[n] — L_out rows that must not be trusted
    quarantine_in: np.ndarray   # bool[n]

    @property
    def clean(self) -> bool:
        return not self.bad_blocks


def _split_rows(name: str, mat: np.ndarray, row_block: int) -> dict:
    return {
        f"{name}.{k:05d}": mat[k * row_block: (k + 1) * row_block]
        for k in range((mat.shape[0] + row_block - 1) // row_block or 1)
    }


def _oracle_arrays(oracle, row_block: int) -> Tuple[dict, dict]:
    arrays = {}
    arrays.update(_split_rows("L_out", oracle.L_out, row_block))
    arrays.update(_split_rows("L_in", oracle.L_in, row_block))
    arrays["out_len"] = oracle.out_len
    arrays["in_len"] = oracle.in_len
    if oracle.hop_rank is not None:
        arrays["hop_rank"] = oracle.hop_rank
    meta = {
        "kind": "ReachabilityOracle",
        "n": oracle.n,
        "lo_width": int(oracle.L_out.shape[1]),
        "li_width": int(oracle.L_in.shape[1]),
        "row_block": int(row_block),
        "has_hop_rank": oracle.hop_rank is not None,
    }
    return arrays, meta


def save_oracle(path: str, oracle, row_block: int = ROW_BLOCK, extra_meta: Optional[dict] = None) -> str:
    """Atomic, checksummed snapshot of a finalized oracle."""
    arrays, meta = _oracle_arrays(oracle, row_block)
    if extra_meta:
        meta.update(extra_meta)
    return save_blocks(path, arrays, meta)


def _assemble_side(name, arrays, meta, n, width, bad_rows):
    """Reassemble one label matrix from its row blocks; quarantine holes."""
    rb = int(meta["row_block"])
    mat = np.zeros((n, width), dtype=np.int32)
    for k in range((n + rb - 1) // rb or 1):
        blk = arrays.get(f"{name}.{k:05d}")
        lo, hi = k * rb, min((k + 1) * rb, n)
        if blk is None:
            bad_rows[lo:hi] = True
        elif blk.shape[0]:
            mat[lo:hi] = blk
    return mat


def _load_oracle_parts(arrays, meta, bad):
    from repro_torch.core.oracle import ReachabilityOracle

    n = int(meta["n"])
    q_out = np.zeros(n, dtype=bool)
    q_in = np.zeros(n, dtype=bool)
    L_out = _assemble_side("L_out", arrays, meta, n, int(meta["lo_width"]), q_out)
    L_in = _assemble_side("L_in", arrays, meta, n, int(meta["li_width"]), q_in)
    out_len = arrays.get("out_len")
    in_len = arrays.get("in_len")
    if out_len is None:  # lengths gone: the whole side is untrustworthy
        q_out[:] = True
        out_len = np.zeros(n, dtype=np.int32)
    if in_len is None:
        q_in[:] = True
        in_len = np.zeros(n, dtype=np.int32)
    hop_rank = arrays.get("hop_rank") if meta.get("has_hop_rank") else None
    if meta.get("has_hop_rank") and hop_rank is None:
        warnings.warn("snapshot hop_rank block corrupt: unrank() unavailable",
                      stacklevel=3)
    oracle = ReachabilityOracle(
        L_out=L_out, L_in=L_in,
        out_len=np.asarray(out_len, dtype=np.int32),
        in_len=np.asarray(in_len, dtype=np.int32),
        hop_rank=None if hop_rank is None else np.asarray(hop_rank, dtype=np.int32),
    )
    return oracle, LoadReport(bad_blocks=list(bad), quarantine_out=q_out, quarantine_in=q_in)


def load_oracle(path: str, strict: bool = True):
    """Load + verify an oracle snapshot.

    ``strict=True``: returns the oracle, raises ``CorruptSnapshotError`` on
    ANY checksum mismatch.  ``strict=False``: returns ``(oracle, report)``
    with corrupt row blocks zeroed and quarantined in the report."""
    arrays, meta, bad = load_blocks(path, strict=strict)
    if meta.get("kind") != "ReachabilityOracle":
        raise CorruptSnapshotError(
            f"{path}: expected a ReachabilityOracle snapshot, found {meta.get('kind')!r}")
    oracle, report = _load_oracle_parts(arrays, meta, bad)
    return oracle if strict else (oracle, report)


# ------------------------------------------------ budget-truncated stores

def save_budgeted(path: str, store, row_block: int = ROW_BLOCK) -> str:
    """Snapshot a ``serve.budget.TruncatedStore``: the truncated oracle's
    row blocks plus its packed truncation masks as their own block kind
    (``trunc_mask_out`` / ``trunc_mask_in``), so a budgeted serving tier
    can restart straight into its cut without re-truncating — or without
    ever holding the full store (edge hosts)."""
    arrays, meta = _oracle_arrays(store.oracle, row_block)
    packed_out, packed_in = store.packed_masks()
    arrays["trunc_mask_out"] = packed_out
    arrays["trunc_mask_in"] = packed_in
    meta.update(
        kind="BudgetedOracle",
        rank_cut=int(store.rank_cut),
        budget_bytes=int(store.budget_bytes),
        resident_bytes=int(store.resident_bytes),
        dropped_ints=int(store.dropped_ints),
    )
    return save_blocks(path, arrays, meta)


def load_budgeted(path: str, strict: bool = True):
    """Load + verify a budget-truncated store (see ``load_oracle`` for the
    strictness contract).

    Corruption semantics COMPOSE with the row-block semantics above: label
    row blocks quarantine exactly as in ``load_oracle`` (the report's masks
    feed ``QueryEngine.set_quarantine`` as usual), while a corrupt
    truncation-MASK block conservatively marks every row of that side as
    truncated.  Over-marking is safe by construction — truncation marks
    only ever route more label misses to the exact-search rung, so a lost
    mask costs latency, never a wrong verdict."""
    from repro_torch.serve.budget import TruncatedStore, unpack_mask

    arrays, meta, bad = load_blocks(path, strict=strict)
    if meta.get("kind") != "BudgetedOracle":
        raise CorruptSnapshotError(
            f"{path}: expected a BudgetedOracle snapshot, found {meta.get('kind')!r}")
    oracle, report = _load_oracle_parts(arrays, meta, bad)
    n = int(meta["n"])

    def _mask(name: str) -> np.ndarray:
        blk = arrays.get(name)
        if blk is None:
            warnings.warn(
                f"{path}: {name} block corrupt; treating every row of that "
                "side as truncated (conservative: misses route to search)",
                stacklevel=2)
            return np.ones(n, dtype=bool)
        return unpack_mask(blk, n)

    store = TruncatedStore(
        oracle=oracle,
        truncated_out=_mask("trunc_mask_out"),
        truncated_in=_mask("trunc_mask_in"),
        rank_cut=int(meta["rank_cut"]),
        budget_bytes=int(meta["budget_bytes"]),
        resident_bytes=int(meta.get("resident_bytes", 0)),
        dropped_ints=int(meta.get("dropped_ints", 0)),
    )
    return store if strict else (store, report)


# ------------------------------------------------------------- LabelEpoch

def save_epoch(path: str, epoch, row_block: int = ROW_BLOCK) -> str:
    """Snapshot a ``repro_torch.dynamic.versioned.LabelEpoch`` (oracle + comp
    + level + epoch number) in one checksummed directory."""
    arrays, meta = _oracle_arrays(epoch.oracle, row_block)
    arrays["comp"] = np.asarray(epoch.comp, dtype=np.int32)
    arrays["level"] = np.asarray(epoch.level, dtype=np.int32)
    meta.update(kind="LabelEpoch", epoch=int(epoch.epoch))
    return save_blocks(path, arrays, meta)


def load_epoch(path: str, strict: bool = True, device="cuda"):
    """Load + verify a LabelEpoch snapshot (see ``load_oracle`` for the
    strictness contract).  A corrupt ``comp`` block is fatal regardless of
    ``strict`` — there is no safe fallback for the id map.  The epoch serves
    on ``device`` (default ``"cuda"``; ``RuntimeError`` without a card)."""
    from repro_torch.device import resolve_device
    from repro_torch.dynamic.versioned import LabelEpoch

    device = resolve_device(device)
    arrays, meta, bad = load_blocks(path, strict=strict)
    if meta.get("kind") != "LabelEpoch":
        raise CorruptSnapshotError(
            f"{path}: expected a LabelEpoch snapshot, found {meta.get('kind')!r}")
    comp = arrays.get("comp")
    if comp is None:
        raise CorruptSnapshotError(
            f"{path}: comp block corrupt — a LabelEpoch cannot serve without "
            "its vertex->condensation map")
    level = arrays.get("level")
    if level is None:
        warnings.warn(f"{path}: level block corrupt; level prefilter disabled",
                      stacklevel=2)
    oracle, report = _load_oracle_parts(arrays, meta, bad)
    ep = LabelEpoch(
        epoch=int(meta["epoch"]),
        oracle=oracle,
        comp=np.asarray(comp, dtype=np.int32),
        level=None if level is None else np.asarray(level, dtype=np.int32),
        device=device,
    )
    return ep if strict else (ep, report)
