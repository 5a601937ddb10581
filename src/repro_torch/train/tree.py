"""Nests of dicts, lists and tuples, walked as JAX walks a pytree: dict keys
in sorted order, list and tuple items in order, a leaf named by its key
path (``"blocks/attn/wq"``, ``"blocks/0/attn/wq"``).  Anything else (a
tensor, a ``ParamSpec``, None) is a leaf."""
from __future__ import annotations


def items(tree, prefix=""):
    """[(key path, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in items(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flattening order."""
    return [leaf for _, leaf in items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching nodes of ``rest``
    (which may hold a whole sub-tree where ``tree`` holds a leaf, as
    ``flatten_up_to`` allows)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(flat: dict) -> dict:
    """{key path: leaf} -> the nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out
