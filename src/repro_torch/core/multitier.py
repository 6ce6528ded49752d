"""Multi-tier (>2) generalization — the paper's §6 future work, built the
way §1 prescribes: "applied to more than two tiers by iteratively splitting
a tier into two".

The port's counterpart of `repro.core.multitier`. Tier construction (n
tiers, budgets B_1 < B_2 < ... < B_{n-1} < |D|): one solve at the largest
budget on `device`; each smaller tier is the longest prefix of its
selection order that fits its budget, so the clause sets, and with them
the full-corpus match-set unions, nest.
Routing: a query goes to the smallest tier whose clause set covers it;
Theorem 3.1 applies per level, so every tier serves complete match sets for
its eligible queries (`verify_multitier` checks it over the whole log).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bitset
from repro_torch.core.config import SolveConfig
from repro_torch.core.problem import SCSKProblem
from repro_torch.core.tiering import ClauseTiering


@dataclasses.dataclass
class MultiTiering:
    tiers: list[ClauseTiering]        # smallest (tier 1) first
    tier_docs: list[np.ndarray]       # bool [n_docs] per tier (nested), full last

    def route(self, query_bits: np.ndarray) -> np.ndarray:
        """Per query: index of the smallest eligible tier (0-based);
        len(tiers) = the full index (always eligible)."""
        out = np.full(query_bits.shape[0], len(self.tiers), np.int32)
        for level in range(len(self.tiers) - 1, -1, -1):
            elig = self.tiers[level].classify_queries(query_bits)
            out[elig] = level
        return out

    def coverage(self, query_bits: np.ndarray, weights: np.ndarray) -> list[float]:
        """Traffic fraction served at each tier (last entry = full index)."""
        routes = self.route(query_bits)
        return [float(weights[routes == k].sum())
                for k in range(len(self.tiers) + 1)]

    def expected_cost(self, query_bits: np.ndarray, weights: np.ndarray) -> float:
        """Expected scanned-doc fraction per query vs the untiered system."""
        routes = self.route(query_bits)
        sizes = [d.mean() for d in self.tier_docs] + [1.0]
        cov = self.coverage(query_bits, weights)
        return float(sum(c * sizes[k] for k, c in enumerate(cov)))


def build_multitier(data, budgets: list[int], *, solver="optpes",
                    device=None, **solver_kw) -> MultiTiering:
    """budgets: ascending Tier-1..Tier-(n-1) document budgets.

    `solver` is a registry name (or a `(problem, budget, **kw)` callable);
    solver-specific knobs ride in `solver_kw`. The solve runs on `device`
    (default CUDA). One solve at the largest budget; each smaller tier is
    the longest prefix of its order fitting its budget (paper Fig. 3: the
    greedy path is the whole solution path), so X_1 ⊆ X_2 ⊆ ... and
    Theorem 3.1 holds globally at every level.
    """
    assert list(budgets) == sorted(budgets), "budgets must ascend"
    problem = SCSKProblem.from_data(data, device)
    if callable(solver):
        result = solver(problem, budgets[-1], **solver_kw)
    else:
        from repro_torch.core import registry
        cfg_kw = {k: solver_kw.pop(k) for k in
                  ("max_steps", "record_every", "time_limit", "seed",
                   "stop_policy") if k in solver_kw}
        result = registry.solve(problem, SolveConfig(
            budget=float(budgets[-1]), solver=solver, options=solver_kw,
            **cfg_kw))
    order = result.order
    assert order, "empty solve"

    # cumulative doc coverage along the selection path
    tiers: list[ClauseTiering] = []
    tier_docs: list[np.ndarray] = []
    cum = np.zeros(data.clause_doc_bits.shape[1], np.uint32)
    cum_sizes = []
    for j in order:
        cum = cum | data.clause_doc_bits[j]
        cum_sizes.append(int(bitset.np_popcount(cum)))
    for budget in budgets:
        k = 0
        while k < len(order) and cum_sizes[k] <= budget:
            k += 1
        sel = np.zeros(problem.n_clauses, bool)
        sel[order[:k]] = True
        tier = ClauseTiering.from_selection(data, sel)
        tiers.append(tier)
        tier_docs.append(tier.tier1_docs)
    return MultiTiering(tiers=tiers, tier_docs=tier_docs)


def verify_multitier(mt: MultiTiering, data) -> bool:
    """Per-level Theorem 3.1 + nesting. Exhaustive over the query log."""
    for k in range(len(mt.tiers) - 1):
        if not np.all(mt.tier_docs[k] <= mt.tier_docs[k + 1]):
            return False
    routes = mt.route(data.log.query_bits)
    t_bits = [bitset.np_pack(d) for d in mt.tier_docs]
    for k, tb in enumerate(t_bits):
        q_at_k = routes == k
        if not q_at_k.any():
            continue
        missing = np.any(data.query_doc_bits[q_at_k] & ~tb[None, :])
        if missing:
            return False
    return True
