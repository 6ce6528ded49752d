"""Per-shard budget allocation from observed traffic (shard-aware tiering).

The port's own copy of `repro.api.partition` (numpy, host side).

The paper's knapsack budget B models one machine's index capacity; a fleet
has per-shard capacity. This module turns a traffic distribution into the
per-shard caps of a `core.constraint.PartitionedBudget`:

  * `shard_traffic_shares` — each shard's share of the fleet's word-traffic
    demand: share_k ∝ Σ_q w(q) · |m(q) ∩ D_k| over the doc partition. This
    is what the shard actually serves (its slice of every match set), so a
    hot shard is one whose documents the traffic keeps matching.
  * `partition_budgets` — B_k = total · share_k, clamped to each shard's
    physical doc capacity, integerized by largest remainder, with overflow
    redistributed to shards that still have headroom. Deterministic.

`TieringPipeline.solve(budget_split="traffic", n_shards=K)` composes the
two against its own query-doc incidence and the live solve weights.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import bitset


def shard_traffic_shares(query_doc_bits: np.ndarray, weights: np.ndarray,
                         bounds: Sequence[int]) -> np.ndarray:
    """f64 [P] normalized traffic demand per doc partition.

    query_doc_bits : packed m(q) per unique query, uint32 [Nq, Wd]
    weights        : empirical query distribution, [Nq]
    bounds         : word offsets of the partition (len P+1)
    """
    bounds = tuple(int(b) for b in bounds)
    w = np.asarray(weights, np.float64)
    demand = np.asarray(
        [(w * bitset.np_popcount(query_doc_bits[:, lo:hi])).sum()
         for lo, hi in zip(bounds, bounds[1:])], np.float64)
    total = demand.sum()
    if total <= 0:
        return np.full(len(bounds) - 1, 1.0 / (len(bounds) - 1))
    return demand / total


def partition_budgets(shards, weights, total: float) -> dict[int, float]:
    """Size per-shard caps B_k from traffic shares; Σ B_k == int(total).

    shards  : per-shard doc capacities — plain ints, or objects with an
              `n_docs` (the reference's `cluster.DocShard`s)
    weights : per-shard traffic shares (any nonnegative vector; normalized
              here), e.g. `shard_traffic_shares(...)` or a decayed online
              estimate
    total   : the fleet-wide Tier-1 doc budget

    Caps are integers (doc counts): largest-remainder rounding, with any
    mass a full shard cannot absorb redistributed to shards that still have
    headroom, proportionally to their share. Raises if `total` exceeds the
    fleet's physical capacity.
    """
    capacity = np.asarray(
        [s if isinstance(s, (int, np.integer)) else int(s.n_docs)
         for s in shards], np.float64)
    share = np.asarray(weights, np.float64)
    if share.shape != capacity.shape:
        raise ValueError(
            f"need one weight per shard: {share.shape} vs {capacity.shape}")
    if np.any(share < 0):
        raise ValueError("traffic shares must be nonnegative")
    total = float(int(total))
    if total > capacity.sum():
        raise ValueError(f"total budget {total:.0f} exceeds fleet capacity "
                         f"{capacity.sum():.0f}")
    share = share / share.sum() if share.sum() > 0 \
        else np.full_like(capacity, 1.0 / len(capacity))

    caps = np.zeros_like(capacity)
    remaining = total
    live = np.ones(len(capacity), bool)      # shards below capacity
    # water-fill: give each live shard its proportional ask, clamp at
    # capacity, re-split what the clamped shards couldn't take
    while remaining > 1e-9 and live.any():
        s = share * live
        if s.sum() <= 0:                      # only zero-share shards left
            s = live.astype(np.float64)
        ask = remaining * s / s.sum()
        grant = np.minimum(ask, capacity - caps)
        caps += grant
        remaining -= grant.sum()
        live = capacity - caps > 1e-9
        if grant.sum() <= 1e-12:
            break
    # integerize by largest remainder without breaching capacity
    floors = np.floor(caps)
    leftover = int(round(total - floors.sum()))
    order = np.argsort(-(caps - floors))
    for k in order:
        if leftover <= 0:
            break
        if floors[k] + 1 <= capacity[k]:
            floors[k] += 1
            leftover -= 1
    return {k: float(floors[k]) for k in range(len(floors))}
