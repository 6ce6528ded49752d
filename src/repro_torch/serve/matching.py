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


def tier_postings(postings: torch.Tensor, tier1_docs: np.ndarray) -> torch.Tensor:
    """Restrict int32 postings words [V, W] to Tier-1 documents, on their
    device.

    As the reference's host `tier_postings`: global doc ids are kept and
    the rows masked, which preserves result-set semantics exactly (a
    production Tier-1 would re-index a compacted doc space).
    """
    mask = bitset.to_tensor(bitset.np_pack(tier1_docs), postings.device)
    return postings & mask[None, :]


def pad_token_batch(queries: list[tuple[int, ...]], pad_len: int | None = None) -> np.ndarray:
    l = pad_len or max((len(q) for q in queries), default=1)
    out = np.full((len(queries), l), -1, np.int32)
    for i, q in enumerate(queries):
        out[i, :len(q)] = list(q)[:l]
    return out


def pack_query_bits(queries: list[tuple[int, ...]], vocab_size: int) -> np.ndarray:
    """Token tuples -> packed uint32 vocab bitsets [B, Wv] on the host.

    The front-end result cache keys on these rows' bytes
    (`cluster.router`), so they are the reference's uint32 words exactly;
    the device-side packing for ψ is `bitset.pack_tokens`.
    """
    qbits = np.zeros((len(queries), vocab_size), bool)
    for i, q in enumerate(queries):
        qbits[i, list(q)] = True
    return bitset.np_pack(qbits)


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
