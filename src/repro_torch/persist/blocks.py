"""Checksummed array-block snapshots (the persistence primitive).

A copy of ``repro.persist.blocks`` (numpy only): the on-disk format is the
same byte for byte, so a snapshot written by either package loads in the
other (``tests/test_torch_build_checkpoint.py``).

Layout of one snapshot directory::

    <dir>/manifest.json        block table + user meta + manifest hash
    <dir>/<block>.npy          one numpy array per named block

Write protocol: everything lands in ``<dir>.tmp`` first, then one
``os.rename`` publishes the snapshot — a crash mid-save leaves the previous
snapshot untouched and at worst a stale ``.tmp`` that the next save clears.

Read protocol: the manifest's own SHA-256 is verified first (a corrupt
block table cannot be trusted to name its blocks), then every block's CRC32.
``strict=True`` (default) raises ``CorruptSnapshotError`` naming the block,
the expected and the observed checksum — loud failure, never garbage
arrays.  ``strict=False`` returns the readable blocks and the list of bad
ones, for a reader that can quarantine the rows backed by a bad block and
keep serving the rest.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import warnings
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ft import inject

MANIFEST_NAME = "manifest.json"
_FORMAT = 1


class CorruptSnapshotError(RuntimeError):
    """A snapshot failed checksum verification (the diagnostic names the
    block and both checksums — this error must stay loud, never be turned
    into a default value)."""


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def save_blocks(path: str, arrays: Dict[str, np.ndarray], meta: Optional[dict] = None) -> str:
    """Atomically write ``arrays`` as a checksummed snapshot at ``path``.

    Block names become file names (keep them to ``[A-Za-z0-9._-]``).
    Returns the final path."""
    meta = dict(meta or {})
    tmp = path.rstrip("/") + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    table = {}
    for name, arr in arrays.items():
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad block name {name!r}")
        fname = f"{name}.npy"
        fpath = os.path.join(tmp, fname)
        np.save(fpath, np.ascontiguousarray(arr), allow_pickle=False)
        with open(fpath, "rb") as f:
            raw = f.read()
        table[name] = {
            "file": fname,
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            "nbytes": len(raw),
            "dtype": str(arr.dtype),
            "shape": list(np.asarray(arr).shape),
        }
    body = {"format": _FORMAT, "meta": meta, "blocks": table}
    manifest = dict(body, manifest_sha256=hashlib.sha256(_canonical(body)).hexdigest())
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    # chaos hook: a crash here must leave the previous snapshot intact
    inject.fire("persist.pre_rename", path=path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def load_blocks(
    path: str,
    strict: bool = True,
    only: Optional[Iterable[str]] = None,
) -> Tuple[Dict[str, Optional[np.ndarray]], dict, List[str]]:
    """Load a snapshot, verifying every checksum.

    Returns ``(arrays, meta, bad_blocks)``.  With ``strict=True`` any
    corruption raises ``CorruptSnapshotError`` and ``bad_blocks`` is always
    empty; with ``strict=False`` unreadable blocks come back as ``None`` and
    are listed in ``bad_blocks``.  ``only`` restricts which blocks are read
    (manifest + meta are always verified in full)."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise CorruptSnapshotError(f"no manifest at {mpath}: not a snapshot")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptSnapshotError(f"unreadable manifest {mpath}: {e}") from e
    claimed = manifest.get("manifest_sha256")
    body = {k: manifest[k] for k in ("format", "meta", "blocks") if k in manifest}
    actual = hashlib.sha256(_canonical(body)).hexdigest()
    if claimed != actual:
        # a tampered block table could point checksums at the wrong files;
        # nothing downstream is trustworthy, so this is fatal even non-strict
        raise CorruptSnapshotError(
            f"manifest hash mismatch at {mpath}: manifest says {claimed}, "
            f"content hashes to {actual}")
    arrays: Dict[str, Optional[np.ndarray]] = {}
    bad: List[str] = []
    names = set(only) if only is not None else None
    for name, entry in manifest["blocks"].items():
        if names is not None and name not in names:
            continue
        fpath = os.path.join(path, entry["file"])
        err = None
        raw = None
        if not os.path.isfile(fpath):
            err = "block file missing"
        else:
            with open(fpath, "rb") as f:
                raw = f.read()
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            if crc != entry["crc32"]:
                err = (f"crc mismatch: manifest 0x{entry['crc32']:08x}, "
                       f"file 0x{crc:08x} over {len(raw)} bytes")
        if err is None:
            try:
                arr = np.load(fpath, allow_pickle=False)
            except Exception as e:  # crc passed but npy parse failed
                err = f"undecodable npy: {e}"
            else:
                arrays[name] = arr
                continue
        diag = f"snapshot block '{name}' at {fpath}: {err}"
        if strict:
            raise CorruptSnapshotError(diag)
        warnings.warn(f"quarantining {diag}", stacklevel=2)
        arrays[name] = None
        bad.append(name)
    return arrays, manifest["meta"], bad


def snapshot_meta(path: str) -> dict:
    """Read just the (verified) meta dict of a snapshot."""
    _, meta, _ = load_blocks(path, strict=True, only=())
    return meta


# ---------------------------------------------------------------- ragged

# rows that one C-level pass over python rows takes at a time: a pass holds
# the interpreter lock throughout, and a dynamic oracle's publish packs its
# state in a worker thread while the serving thread waits for that lock
ROWS_PER_PASS = 1 << 14


def row_lengths(rows: Sequence[Sequence[int]]) -> np.ndarray:
    """``len`` of every row, int64, a pass of ``ROWS_PER_PASS`` rows at a time."""
    parts = [np.fromiter(map(len, rows[i:i + ROWS_PER_PASS]), dtype=np.int64)
             for i in range(0, len(rows), ROWS_PER_PASS)]
    return np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)


def concat_rows(rows: Sequence[Iterable[int]], dtype, fn=None) -> np.ndarray:
    """The rows' values (each row mapped through ``fn`` first, if given) end
    to end, a pass of ``ROWS_PER_PASS`` rows at a time."""
    parts = []
    for i in range(0, len(rows), ROWS_PER_PASS):
        part = rows[i:i + ROWS_PER_PASS]
        if fn is not None:
            part = map(fn, part)
        parts.append(np.fromiter(itertools.chain.from_iterable(part), dtype=dtype))
    return np.concatenate(parts) if parts else np.empty(0, dtype=dtype)


def pack_ragged(rows: Sequence[Sequence[int]], dtype=np.int32) -> Tuple[np.ndarray, np.ndarray]:
    """Python list-of-lists -> (values, offsets int64[k+1]) block pair.

    The arrays of ``repro.persist.blocks.pack_ragged``, built in passes over
    the rows (the dynamic oracle packs ~700k member lists a snapshot)."""
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(row_lengths(rows), out=offsets[1:])
    return concat_rows(rows, dtype), offsets


def unpack_ragged(values: np.ndarray, offsets: np.ndarray) -> List[list]:
    """Inverse of ``pack_ragged`` (plain python lists)."""
    vals, offs = values.tolist(), offsets.tolist()
    return [vals[offs[i]: offs[i + 1]] for i in range(len(offs) - 1)]
