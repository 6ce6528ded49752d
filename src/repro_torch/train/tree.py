"""Nested dicts of tensors as the reference's pytrees: leaves in sorted-key
order (as `jax.tree.leaves` orders a dict), paths '/'-joined."""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf, keys sorted at each level; a list or tuple
    level is keyed by index. An empty dict holds no leaf."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map(fn: Callable, tree, *rest):   # noqa: A001  (jax.tree.map's name)
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    the nesting of `tree` kept."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unzip(tree, n: int) -> list:
    """n trees from a tree whose leaves are n-tuples (a `map` whose fn
    returned n values); a list level is nesting, a tuple a leaf."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    if isinstance(tree, list):
        parts = [unzip(v, n) for v in tree]
        return [[p[j] for p in parts] for j in range(n)]
    return list(tree)


def unflatten_like(tree, values: list):
    """`tree`'s nesting with its leaves replaced, in `leaves` order."""
    paths = [p for p, _ in leaves_with_paths(tree)]
    if len(paths) != len(values):
        raise ValueError(f"{len(values)} values for {len(paths)} leaves")
    return _rebuild(tree, dict(zip(paths, values)), "")


def _rebuild(tree, by_path: dict, prefix: str):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, by_path, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return by_path[prefix]


def describe(tree):
    """The nesting of `tree` with each leaf as "dtype[shape]": the port's
    description of a state's structure (the reference writes JAX's treedef
    repr)."""
    return map(lambda x: f"{str(getattr(x, 'dtype', type(x).__name__)).replace('torch.', '')}"
                         f"{list(getattr(x, 'shape', ()))}", tree)
