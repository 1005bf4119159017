"""Trees of tensors: nested dicts, lists, tuples and NamedTuples (an
optimizer state), with ``None`` as an empty subtree, as ``jax.tree``
treats them.  ``is_leaf`` stops the walk at a node that it accepts, as
``jax.tree``'s does (a partition spec is a tuple, yet a leaf)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

Tree = Any


def _rebuild(like, items: list):
    # a NamedTuple (an optimizer state) takes its fields positionally
    return (type(like)(*items) if hasattr(like, "_fields")
            else type(like)(items))


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Optional[Callable] = None) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the same-structured
    ``rest``; the structure follows ``tree``, and ``None`` stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, *items, is_leaf=is_leaf)
                               for items in zip(tree, *rest)])
    return fn(tree, *rest)


def leaves(tree: Tree, is_leaf: Optional[Callable] = None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order: dict values by
    sorted key, list and tuple items in order; ``None`` holds no leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in leaves(item, is_leaf)]
    return [] if tree is None else [tree]


def unflatten(like: Tree, items: Iterable) -> Tree:
    """``items`` (in ``leaves`` order) put into the structure of ``like``."""
    it = iter(items)

    def fill(node):
        if isinstance(node, dict):
            filled = {k: fill(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [fill(item) for item in node])
        return None if node is None else next(it)

    return fill(like)
