"""Fault-tolerant checkpoints of a tree of tensors, the port of
``repro.checkpoint.ckpt``, in its layout: ``<dir>/step_<N>/arrays.npz``
(``leaf_<i>``, the leaves in ``jax.tree.flatten``'s order,
``repro_torch.tree``) and ``tree.json``, written to a temporary directory
and renamed into place (a crash mid-save never corrupts the latest
checkpoint), the oldest past ``keep`` removed.  So either package restores
the other's checkpoints of the same tree.  bfloat16 leaves are stored as
the JAX package stores them: two raw bytes a value (numpy ``|V2``).

``AsyncCheckpointer`` copies the tree to the host at once and writes the
files in a thread, at most one save in flight.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten, treedef_str


def _host(x) -> np.ndarray:
    """A leaf as the numpy array the checkpoint stores."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)   # a copy: training updates the tree in place
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _leaf(arr: np.ndarray, like):
    """A stored array as a leaf like ``like``: a tensor on ``like``'s device
    (``|V2`` read as bfloat16) for a tensor, else the array."""
    if not isinstance(like, torch.Tensor):
        return arr
    arr = np.array(arr, order="C")   # 0-d stays 0-d (np.ascontiguousarray makes it 1-d)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Blocking save. Returns the final checkpoint path.  A save writes into
    a directory of its own and publishes it by one rename, so two writers of
    one step (a failed run's save still in flight beside its restart, in one
    process) never share a file; where the other publishes the step between
    this one's removal of it and its rename, the other's copy stands."""
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step}")
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"treedef": treedef_str(treedef), "n_leaves": len(leaves), "step": step}, f)
    if os.path.exists(final):
        shutil.rmtree(final, ignore_errors=True)
    try:
        os.rename(tmp, final)  # atomic publish
    except OSError:
        if not os.path.isdir(final):
            raise
        shutil.rmtree(tmp, ignore_errors=True)
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_"))


def _gc(ckpt_dir: str, keep: int) -> None:
    """Drop all but the last ``keep`` steps, and the unpublished directories
    (a crashed save's) of steps older than the oldest kept."""
    steps = _steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    oldest = steps[-keep:][0] if steps[-keep:] else None
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_step_") and oldest is not None and \
                int(d.split("_")[2]) < oldest:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf's shape checked
    (``ValueError`` on a mismatch), its stored dtype kept, a tensor leaf on
    the device of ``like``'s."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    leaves_like, treedef = tree_flatten(like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = []
        for i, ref in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            ref_shape = tuple(getattr(ref, "shape", np.shape(ref)))
            if tuple(arr.shape) != ref_shape:
                raise ValueError(f"leaf {i}: ckpt {arr.shape} != expected {ref_shape}")
            leaves.append(_leaf(arr, ref))
    return tree_unflatten(treedef, leaves)


class AsyncCheckpointer:
    """Fire-and-forget saves with at most one in flight (back-pressure)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # the device -> host copy now (so the tree can keep training), the I/O in a thread
        host_tree = tree_map(_host, tree)

        def _run():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
