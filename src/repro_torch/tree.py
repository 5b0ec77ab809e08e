"""Trees of tensors: nested dicts, NamedTuples, lists and tuples, with
leaves in JAX's order (dict keys sorted, NamedTuple fields in order).

The port keeps parameters and optimizer state as such trees, as the JAX
package keeps pytrees.  ``flatten_with_keys`` names each leaf as
``jax.tree_util.tree_flatten_with_path`` does in
``repro.checkpoint.store._flatten``: dict keys, NamedTuple field names
and sequence indices joined by ``/``.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree: Any, items: list[tuple[Any, Any]]) -> Any:
    if isinstance(tree, dict):
        new = dict(items)
        return {k: new[k] for k in tree}
    values = [v for _, v in items]
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def flatten_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """[(key path joined by '/', leaf)] in JAX's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, child in kids:
        for sub, leaf in flatten_with_keys(child):
            out.append((f"{key}/{sub}" if sub else str(key), leaf))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def unflatten_like(like: Any, values: list) -> Any:
    """``like``'s structure with its leaves replaced, in order, by ``values``."""
    it = iter(values)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [(k, build(c)) for k, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    others = [leaves(r) for r in rest]
    return unflatten_like(tree, [fn(*args) for args in zip(leaves(tree), *others, strict=True)])
