"""Production-scale sparse SCSK greedy round, on one device.

The port's counterpart of `repro.core.sparse_step`. At |D| ~ 2^26+ the
dense clause x doc bitset matrix does not fit; each clause carries m(c) as
a sorted id list padded with -1, and the covered-doc state stays one packed
bitset. The g-gains come from one `ops.sparse_gain` launch, the f-gains
from one `ops.bit_matvec` launch over the packed clause x query bits. The
mesh form of the reference (clause lists sharded, rows owner-gathered) is
a later part of the port; on one device the selected clause's rows are
plain row reads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.greedy import ratio_of
from repro_torch.kernels import ops


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
    fg = ops.bit_matvec(clause_query_bits, x)[:, 0]
    gg = ops.sparse_gain(clause_doc_ids, covered_d).to(torch.float32)
    feasible = (~selected) & (g_used + gg <= budget) & (fg > 0.0)
    score = torch.where(feasible, ratio_of(fg, gg), float("-inf"))
    j = torch.argmax(score)      # first maximum; 0 when every score is -inf
    j, stop = torch.stack([j, (~feasible[j]).long()]).tolist()
    if stop:
        return covered_q, covered_d, selected, g_used, j, True
    ids_j = clause_doc_ids[j]
    # match-set id lists are sorted and unique by construction
    covered_d = covered_d | bitset.from_indices(
        ids_j, covered_d.shape[0] * bitset.WORD, valid=ids_j >= 0,
        unique=True)
    covered_q = covered_q | clause_query_bits[j]
    selected = selected.clone()
    selected[j] = True
    return covered_q, covered_d, selected, g_used + gg[j], j, False
