"""The JAX package's params as the port's: a tree of dicts and lists whose
leaves are numpy arrays (``jax.tree.map(np.asarray, params)``) becomes the
same tree of torch tensors, with the same dtypes."""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_jax(a, device) -> torch.Tensor:
    """A numpy array of the JAX package as a torch tensor on ``device``;
    bfloat16 (ml_dtypes') goes through its bit pattern.  A copy: the arrays
    of JAX's params are read-only views."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_jax(tree, device):
    """``tensor_from_jax`` over a tree of dicts and lists, its structure kept."""
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device) for v in tree]
    return tensor_from_jax(tree, device)
