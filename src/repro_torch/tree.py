"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, flattened
in ``jax.tree.flatten``'s order (dict keys sorted, lists and tuples in
order, NamedTuple fields in order, ``None`` an empty subtree), so that a
checkpoint's leaves line up between the port and the JAX package."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef); ``tree_unflatten(treedef, leaves)`` rebuilds the tree."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if _is_namedtuple(node):
            return ("namedtuple", type(node), [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, None, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in d[2]]
        if kind == "dict":
            return dict(zip(d[1], children))
        if kind == "namedtuple":
            return d[1](*children)
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(treedef) -> str:
    """A readable form of ``treedef`` for a checkpoint's ``tree.json``."""
    kind = treedef[0]
    if kind in ("leaf", "none"):
        return "*" if kind == "leaf" else "None"
    inner = ", ".join(treedef_str(c) for c in treedef[2])
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {treedef_str(c)}"
                               for k, c in zip(treedef[1], treedef[2])) + "}"
    if kind == "namedtuple":
        return f"{treedef[1].__name__}({inner})"
    return f"[{inner}]" if kind == "list" else f"({inner})"
