"""FPGrowth frequent-itemset mining (paper §3.3).

The regularized ground set X̄ = {c : P_{q~Qn}[c ⊆ q] >= λ} is mined from the
weighted unique-query log with FPGrowth [Han et al. 2000], exactly as the
paper does. This is one-off host-side preprocessing (numpy/python), like the
paper's Lucene indexing step. A copy of `repro.data.mining`.

`brute_force_frequent` is the test oracle.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools


@dataclasses.dataclass
class _Node:
    item: int
    count: float
    parent: "_Node | None"
    children: dict[int, "_Node"] = dataclasses.field(default_factory=dict)


def fpgrowth(
    transactions: list[tuple[int, ...]],
    weights: list[float] | None,
    min_support: float,
    *,
    max_len: int = 4,
    max_items: int | None = None,
) -> dict[tuple[int, ...], float]:
    """Weighted FPGrowth.

    transactions: item-id tuples (sets).
    weights:      per-transaction weight (empirical probability); None = 1.0.
    min_support:  λ, in the same unit as weights (probability if weights sum
                  to 1).
    Returns {sorted clause tuple -> support}.
    """
    if weights is None:
        weights = [1.0] * len(transactions)

    item_support: dict[int, float] = collections.defaultdict(float)
    for t, w in zip(transactions, weights):
        for it in set(t):
            item_support[it] += w
    frequent = {it: s for it, s in item_support.items() if s >= min_support}
    # global order: decreasing support, ties by id (deterministic)
    order = {it: r for r, it in enumerate(
        sorted(frequent, key=lambda i: (-frequent[i], i)))}

    root = _Node(item=-1, count=0.0, parent=None)
    header: dict[int, list[_Node]] = collections.defaultdict(list)

    def insert(items: list[int], w: float) -> None:
        node = root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _Node(item=it, count=0.0, parent=node)
                node.children[it] = child
                header[it].append(child)
            child.count += w
            node = child

    for t, w in zip(transactions, weights):
        items = sorted((it for it in set(t) if it in frequent),
                       key=lambda i: order[i])
        if items:
            insert(items, w)

    results: dict[tuple[int, ...], float] = {}

    def mine(suffix: tuple[int, ...], hdr: dict[int, list[_Node]],
             supports: dict[int, float]) -> None:
        if max_items is not None and len(results) >= max_items:
            return
        for it in sorted(supports, key=lambda i: (-supports[i], i)):
            s = supports[it]
            if s < min_support:
                continue
            clause = tuple(sorted(suffix + (it,)))
            results[clause] = s
            if max_items is not None and len(results) >= max_items:
                return
            if len(clause) >= max_len:
                continue
            # conditional pattern base for `it`
            cond: list[tuple[list[int], float]] = []
            for node in hdr[it]:
                path: list[int] = []
                p = node.parent
                while p is not None and p.item != -1:
                    path.append(p.item)
                    p = p.parent
                if path:
                    cond.append((list(reversed(path)), node.count))
            # build conditional tree
            csup: dict[int, float] = collections.defaultdict(float)
            for path, w in cond:
                for x in path:
                    csup[x] += w
            csup = {x: s2 for x, s2 in csup.items() if s2 >= min_support}
            if not csup:
                continue
            croot = _Node(item=-1, count=0.0, parent=None)
            chdr: dict[int, list[_Node]] = collections.defaultdict(list)
            corder = {x: r for r, x in enumerate(
                sorted(csup, key=lambda i: (-csup[i], i)))}
            for path, w in cond:
                items = sorted((x for x in path if x in csup),
                               key=lambda i: corder[i])
                node = croot
                for x in items:
                    child = node.children.get(x)
                    if child is None:
                        child = _Node(item=x, count=0.0, parent=node)
                        node.children[x] = child
                        chdr[x].append(child)
                    child.count += w
                    node = child
            mine(clause, chdr, dict(csup))

    mine((), header, {it: frequent[it] for it in frequent})
    return results


def brute_force_frequent(
    transactions: list[tuple[int, ...]],
    weights: list[float] | None,
    min_support: float,
    *,
    max_len: int = 4,
) -> dict[tuple[int, ...], float]:
    """Test oracle: enumerate every itemset of size <= max_len."""
    if weights is None:
        weights = [1.0] * len(transactions)
    support: dict[tuple[int, ...], float] = collections.defaultdict(float)
    for t, w in zip(transactions, weights):
        items = sorted(set(t))
        for k in range(1, min(max_len, len(items)) + 1):
            for combo in itertools.combinations(items, k):
                support[combo] += w
    return {c: s for c, s in support.items() if s >= min_support}
