"""Parameter and state trees: nested dicts, lists, tuples and NamedTuples
whose leaves are tensors (or arrays, or numbers), walked in
``jax.tree_util``'s order: dict keys sorted, sequence items and NamedTuple
fields in order, ``None`` an empty subtree. A leaf's index and path are
then the JAX package's, which keys its checkpoint files by them
(``repro_torch.checkpoint.store``), and a sum over leaves adds in its
order (``repro_torch.optim.adamw.global_norm``)."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[("a/b/c", leaf), ...] in JAX's leaf order."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix: str, node):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key, child in kids:
            walk(f"{prefix}/{key}" if prefix else key, child)
    walk("", tree)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *parts)
                            for parts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with ``new_leaves`` in JAX's leaf order."""
    it = iter(new_leaves)
    by_path = {path: next(it) for path, _ in flatten_with_paths(like)}

    def build(prefix: str, node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return by_path[prefix]
        got = {key: build(f"{prefix}/{key}" if prefix else key, child)
               for key, child in kids}
        if isinstance(node, dict):
            return {k: got[str(k)] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(got[f] for f in node._fields))
        return type(node)(got[str(i)] for i in range(len(node)))
    return build("", like)


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for these node types,
    e.g. ``PyTreeDef({'a': *, 'b': [*, None]})``."""
    def fmt(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(fmt(c) for c in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(fmt(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(fmt(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
