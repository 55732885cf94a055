"""Pytree helpers with JAX's flatten order.

JAX flattens a dict in SORTED key order, while ``torch.utils._pytree``
keeps insertion order.  Group metas, exec plans and gather perms are all
indexed by leaf position, so the port flattens its nested dicts of tensors
with these helpers: the same leaf order as the reference, hence the same
parameter groups and the same plans.

A tree is a nested ``dict`` whose non-dict values are leaves.  A train
state also holds NamedTuples (``ACEState``, ``ImportanceState``); the
``reference_*`` helpers flatten those too, fields in declared order, as
``jax.tree_util`` does: that order numbers a checkpoint's ``leaf_<k>.npy``
in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def leaves_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in sorted-key (JAX) order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(leaves_with_path(tree[key], prefix + (key,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef is the tree with every leaf
    replaced by ``None``."""
    return leaves(tree), tree_map(lambda _: None, tree)


def unflatten(treedef, flat) -> Any:
    it = iter(flat)
    out = _fill(treedef, it)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over after unflatten")
    return out


def _fill(treedef, it):
    if not isinstance(treedef, dict):
        return next(it)
    return {k: _fill(treedef[k], it) for k in sorted(treedef)}


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and of same-structure
    ``rest`` trees), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def path_str(path: Path) -> str:
    return "/".join(path)


def from_flat_dict(flat: Dict[str, Any]) -> dict:
    """Nest a ``{"a/b/c": leaf}`` dict into ``{"a": {"b": {"c": leaf}}}``."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def reference_leaves_with_path(tree, prefix: Path = ()
                               ) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, NamedTuple fields in declared order."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(reference_leaves_with_path(sub, prefix + (key,)))
    return out


def reference_leaf_paths(tree) -> List[str]:
    """The "/"-joined path of every leaf, in the reference's order (the
    keys ``jax.tree_util.tree_flatten_with_path`` gives its state)."""
    return [path_str(p) for p, _ in reference_leaves_with_path(tree)]


def reference_unflatten(template, flat) -> Any:
    """The inverse of :func:`reference_leaves_with_path`: ``template``'s
    structure with its leaves replaced, in order, by ``flat``."""
    it = iter(flat)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(fill(v) for v in node))
        return next(it)

    out = fill(template)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} leaves left over after unflatten")
    return out
