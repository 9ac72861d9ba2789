"""Parameter trees as the port lays them out (nested dicts, lists and
tuples of tensors), walked in one fixed order: dict insertion order, then
list / tuple order. The reference reads leaves by these paths."""

from __future__ import annotations


def leaves_with_paths(tree, path=()):
    """-> [(path tuple, leaf)], in tree order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, path + (str(i),))]
    return [] if tree is None else [(path, tree)]


def leaves(tree):
    return [x for _, x in leaves_with_paths(tree)]


def rebuild(tree, new_leaves):
    """``tree`` with its leaves replaced, in order."""
    it = iter(new_leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)

    return walk(tree)


def as_flat_dict(tree) -> dict:
    """{"a.b.0.w": leaf} — how the reference reads a tree."""
    return {".".join(p): x for p, x in leaves_with_paths(tree)}
