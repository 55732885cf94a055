"""Pytree helpers with JAX's flatten order.

JAX flattens a dict in SORTED key order, while ``torch.utils._pytree``
keeps insertion order.  Group metas, exec plans and gather perms are all
indexed by leaf position, so the port flattens its nested dicts of tensors
with these helpers: the same leaf order as the reference, hence the same
parameter groups and the same plans.

A tree is a nested ``dict`` whose non-dict values are leaves.
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
