"""Tiered candidate retrieval: the paper's technique in the two-tower
serving path, the counterpart of `repro.models.tiered_retrieval`.

Offline (`build_tiered_index`): items are the documents of the synthetic
corpus over an attribute vocabulary, queries its predicate sets; the
port's `api.TieringPipeline` mines clauses, solves (SCSK, optpes by
default) and derives the tiering, Tier-1 = the union of the selected
clauses' matching items (|Tier-1| <= the budget).

Online (`tiered_retrieval_scores`): ψ^clause routes each query; an eligible
query scores only the Tier-1 rows of the candidate embeddings (|D1|/|D| of
the FLOPs and bytes), any other query the whole corpus. Theorem 3.1
guarantees that an eligible query loses no matching candidate, so its
top-k over matching items is the full corpus's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tiering import ClauseTiering
from repro_torch.data import incidence
from repro_torch.models.common import top_k


@dataclasses.dataclass
class TieredIndex:
    tiering: ClauseTiering
    tier1_ids: np.ndarray            # item ids in Tier 1 (sorted)
    data: incidence.TieringData

    @property
    def tier1_frac(self) -> float:
        return len(self.tier1_ids) / self.data.n_docs


def build_tiered_index(seed: int = 0, scale: str = "tiny", budget_frac: float = 0.5,
                       min_support: float = 1e-3, solver: str = "optpes", *,
                       device=None) -> TieredIndex:
    """Mine, solve and tier the synthetic corpus at `scale` on `device` (the
    card unless the caller names another)."""
    from repro_torch.api import TieringPipeline
    pipe = (TieringPipeline.from_synthetic(seed, scale, device=device)
            .mine(min_support=min_support)
            .solve(solver, budget_frac=budget_frac))
    tiering = pipe.tiering()
    return TieredIndex(tiering=tiering, tier1_ids=np.nonzero(tiering.tier1_docs)[0],
                       data=pipe.data)


def tiered_retrieval_scores(user_emb: torch.Tensor, cand_emb: torch.Tensor,
                            tier1_ids: torch.Tensor, eligible: bool | torch.Tensor,
                            match_mask: torch.Tensor, k: int = 100
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, global ids) of the top-k matching candidates: user_emb [D],
    cand_emb [N, D] (the whole corpus), tier1_ids [N1], eligible ψ(q) (a
    bool, or a 0-d tensor read once), match_mask [N] bool m(q). Rows that do
    not match score -inf. An eligible query reads only the [N1, D] Tier-1
    rows."""
    if bool(eligible):
        s = cand_emb[tier1_ids] @ user_emb
        s = torch.where(match_mask[tier1_ids], s, torch.tensor(float("-inf"), device=s.device))
        v, i = top_k(s, k)
        return v, tier1_ids[i]
    s = cand_emb @ user_emb
    s = torch.where(match_mask, s, torch.tensor(float("-inf"), device=s.device))
    return top_k(s, k)
