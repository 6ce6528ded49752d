"""Secretary-style streaming admission of clauses into Tier 1.

The port's counterpart of `repro.ingest.admission` (a copy: `collections`
only), with the same decisions.

Between warm refits, arriving documents activate clauses the last solve did
NOT select (a clause's marginal f/g ratio changes the moment new docs land in
its match set). Re-solving per arrival is off the table — the whole point of
the SCSK formulation is that solves are periodic — so admission is a ONE-PASS
online decision: each activated clause is offered once, with its current
marginal ratio f(j|X)/g(j|X), and is either admitted into the live selection
now (eviction deferred to the next warm refit) or passed over.

The policy is the classical observe-then-accept secretary relaxation adapted
to an infinite stream: the first `observe` offers are never admitted, only
recorded; afterwards an offer is admitted iff it clears the running
`quantile` of the last `window` observed ratios AND the live knapsack
constraint says the clause still fits every partition it touches. Admitting
only above a trailing quantile keeps the policy scale-free (ratios drift as
coverage saturates) and the constraint gate keeps every admission feasible —
the next refit starts from a feasible warm state.

This mirrors the threshold-based streaming-submodular tradition
(sieve/secretary hybrids); the knapsack-feasibility gate is the part the
tiering setting adds, because admission here spends real per-shard index
budget (`repro_torch.core.constraint.KnapsackConstraint`).

Note the MANDATORY/OPTIONAL split (Theorem 3.1): new docs matching an
already-selected clause are not offers — they MUST enter Tier 1 with their
clause, or eligible queries would miss them. The ingest controller handles
that by re-deriving coverage from the fixed selection (`state_for`); only
unselected clauses reach this policy.
"""
from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class AdmissionDecision:
    clause: int
    ratio: float
    threshold: float
    admitted: bool
    reason: str        # "observe" | "infeasible" | "below" | "admitted"


class AdmissionPolicy:
    """Observe-then-accept trailing-quantile admission.

    observe   : offers recorded (never admitted) before the gate opens
    quantile  : trailing ratio quantile an offer must clear to be admitted
    window    : trailing offers the quantile is computed over
    min_ratio : absolute floor under which nothing is ever admitted
    """

    def __init__(self, *, observe: int = 16, quantile: float = 0.7,
                 window: int = 128, min_ratio: float = 0.0):
        if not 0.0 <= quantile <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {quantile}")
        self.observe = observe
        self.quantile = quantile
        self.min_ratio = min_ratio
        self._ratios: collections.deque[float] = collections.deque(
            maxlen=window)
        self.n_offers = 0
        self.n_admitted = 0
        self.n_infeasible = 0
        self.decisions: list[AdmissionDecision] = []

    def threshold(self) -> float:
        """The ratio an offer must clear right now (inf while observing)."""
        if self.n_offers < self.observe or not self._ratios:
            return float("inf")
        ranked = sorted(self._ratios)
        k = min(len(ranked) - 1, int(self.quantile * len(ranked)))
        return max(ranked[k], self.min_ratio)

    def offer(self, clause: int, ratio: float, feasible: bool) -> bool:
        """One-pass decision for an activated clause; True = admit now."""
        thr = self.threshold()
        self.n_offers += 1
        self._ratios.append(float(ratio))
        if self.n_offers <= self.observe:
            verdict, reason = False, "observe"
        elif not feasible:
            self.n_infeasible += 1
            verdict, reason = False, "infeasible"
        elif ratio >= thr:
            self.n_admitted += 1
            verdict, reason = True, "admitted"
        else:
            verdict, reason = False, "below"
        self.decisions.append(AdmissionDecision(
            clause=int(clause), ratio=float(ratio), threshold=thr,
            admitted=verdict, reason=reason))
        return verdict

    def summary(self) -> str:
        return (f"offers={self.n_offers} admitted={self.n_admitted} "
                f"infeasible={self.n_infeasible} thr={self.threshold():.4g}")
