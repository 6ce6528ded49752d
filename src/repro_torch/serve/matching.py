"""Conjunctive matching over packed postings (paper §2.1, eq. 1).

The port's counterpart of `repro.serve.matching`. m(q) = ∩_{v∈q} postings(v)
— an AND-reduce over packed doc bitsets; a [B, L]-padded token-id batch
gives a [B, Wd] packed match-set batch in one `ops.match_batch` /
`ops.fused_match` call. This module holds the batch helpers around it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.kernels import ops


def pad_token_batch(queries: list[tuple[int, ...]], pad_len: int | None = None) -> np.ndarray:
    l = pad_len or max((len(q) for q in queries), default=1)
    out = np.full((len(queries), l), -1, np.int32)
    for i, q in enumerate(queries):
        out[i, :len(q)] = list(q)[:l]
    return out


def classify_batch(clause_bits: torch.Tensor, tokens: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """Batched ψ^clause (eq. 8) through the `clause_match` kernel.

    `clause_bits` are the selected clauses' int32 vocab words [K, Wv] and
    `tokens` the padded batch [B, L] on the same device; the query bitsets
    are packed there. Semantically identical to
    `ClauseTiering.classify_queries` (the host reference).
    """
    return ops.clause_match(bitset.pack_tokens(tokens, vocab_size),
                            clause_bits)
