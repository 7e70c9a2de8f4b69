"""Nested-dict pytrees flattened in JAX's leaf order.

``jax.tree_util`` flattens a dict in SORTED key order (``conv1.b,
conv1.w, conv2.b, ...``), while ``torch.utils._pytree`` keeps insertion
order. The packed (C, N) slabs of ``repro_torch.core.flat`` only line up
element by element with the reference's when the leaf order is the
same, so the port flattens with these helpers.

A tree is a leaf (anything that is not a dict) or a dict of trees. The
treedef is a tuple of key paths, one per leaf, in flattening order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Tuple[Tuple[str, ...], ...]


def _walk(tree, path, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (k,), out)
    else:
        out.append((path, tree))


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """-> (leaves in sorted-key order, treedef)."""
    items: list = []
    _walk(tree, (), items)
    return [leaf for _, leaf in items], tuple(p for p, _ in items)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    leaves = list(leaves)
    if len(leaves) != len(treedef):
        raise ValueError(f"treedef has {len(treedef)} leaves, got "
                         f"{len(leaves)}")
    if treedef == ((),):
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(treedef, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
