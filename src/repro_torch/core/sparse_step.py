"""Production-scale sparse SCSK greedy round.

The port's counterpart of `repro.core.sparse_step`. At |D| ~ 2^26+ the
dense clause x doc bitset matrix does not fit; each clause carries m(c) as
a sorted id list padded with -1, and the covered-doc state stays one packed
bitset. The g-gains come from one `ops.sparse_gain` launch, the f-gains
from `ops.bit_matvec` over the packed clause x query bits.

Over a mesh with a `"model"` axis whose data axes are of size 1 (a
`("model",)` mesh, or `("data", "model")` with one data rank) the f-gains
are the reference's fused ones: each entry's word slice of the packed
bits, its `bit_matvec` partials summed over the model ranks
(`distributed.model_gains`), and the selected clause's rows are taken
owner-local (`distributed.owner_row`: the id row by a max over the data
ranks, the packed row by a sum). Where the data axes exceed 1 the port
takes its direct path: the reference raises there (its `feasible[j]` is a
dynamic slice of a data-sharded vector, which jax 0.9.0 does not
partition), so there is no fused result to follow.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.core import bitset
from repro_torch.core.greedy import ratio_of
from repro_torch.device import host_values
from repro_torch.kernels import ops


def _fused() -> bool:
    """Fuse over the ambient mesh: a `"model"` mesh whose data axes are of
    size 1 (see the module docstring)."""
    plan = distributed.current_plan()
    return plan.model_fused and all(plan.mesh.shape[a] == 1 for a in plan.data_axes)


def sparse_greedy_step(
    clause_doc_ids: torch.Tensor,     # int32 [C, M] (-1 padded, sorted)
    clause_query_bits: torch.Tensor,  # int32 words [C, Wq]
    query_weights: torch.Tensor,      # f32 [Wq*32]
    covered_q: torch.Tensor,          # int32 words [Wq]
    covered_d: torch.Tensor,          # int32 words [Wd]
    selected: torch.Tensor,           # bool [C]
    g_used: torch.Tensor,             # f32 0-d
    budget: float,
):
    """One cost-ratio greedy selection over the sparse layout.

    Returns (covered_q, covered_d, selected, g_used, j, stop) with `j` and
    `stop` read to the host (the one sync of the step). On `stop` the state
    is returned unchanged; otherwise the new state is built from new
    tensors (the inputs are not modified).
    """
    budget = float(np.float32(budget))       # the reference's f32 budget
    x = (query_weights * (1.0 - bitset.unpack(covered_q).to(torch.float32))
         )[:, None]
    fused = _fused()
    fg = distributed.model_gains(clause_query_bits, x)[0] if fused \
        else ops.bit_matvec(clause_query_bits, x)[:, 0]
    gg = ops.sparse_gain(clause_doc_ids, covered_d).to(torch.float32)
    feasible = (~selected) & (g_used + gg <= budget) & (fg > 0.0)
    score = torch.where(feasible, ratio_of(fg, gg), float("-inf"))
    j = torch.argmax(score).reshape(1)   # first maximum; 0 when every score is -inf
    j, stop = host_values(torch.cat([j, (~feasible[j]).long()]))
    if stop:
        return covered_q, covered_d, selected, g_used, j, True
    ids_j = distributed.owner_row(clause_doc_ids, j, ids=True) if fused \
        else clause_doc_ids[j]
    # match-set id lists are sorted and unique by construction
    covered_d = covered_d | bitset.from_indices(
        ids_j, covered_d.shape[0] * bitset.WORD, valid=ids_j >= 0,
        unique=True)
    covered_q = covered_q | (distributed.owner_row(clause_query_bits, j, w_axis="model")
                             if fused else clause_query_bits[j])
    selected = selected.clone()
    selected[j] = True
    return covered_q, covered_d, selected, g_used + gg[j], j, False
