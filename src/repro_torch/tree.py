"""Nested dictionaries and lists of tensors: the port's pytrees.

The reference keeps parameters, gradients and optimizer moments as JAX
pytrees; the port keeps them as plain nested ``dict``s and ``list``s with
tensors (or numbers) at the leaves.  These helpers walk them in one fixed
order: dictionary keys as stored, list items in order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in order (None is no leaf)."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in order; a path joins dictionary keys and list
    indices with "/", as the reference's checkpoint keys its leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure with ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
