"""Doc-space sharding of the packed postings index.

The port's counterpart of `repro.cluster.shard`. A cluster partitions the
document universe into contiguous, WORD-ALIGNED ranges so every shard's
sub-index is a column slice of the packed postings matrix, and a shard's
local match bitset drops into the global result at `[word_lo:word_hi]`.
Shards partition the doc space, so the scatter-gather OR-merge of
per-shard match bitsets is exactly the single-tier match set (Theorem 3.1
then holds shard-locally).

The slices are taken from the int32 postings words on their device. A
column slice of a row-major matrix is not contiguous and the kernels take
contiguous operands only, so every slice is a contiguous copy (a
one-shard plan's slice is the matrix itself).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset, constraint


@dataclasses.dataclass(frozen=True)
class DocShard:
    """One contiguous word-aligned slice of the document universe."""
    index: int
    word_lo: int     # first postings word owned (inclusive)
    word_hi: int     # last postings word owned (exclusive)
    doc_lo: int      # global id of local doc 0 (== word_lo * 32)
    n_docs: int      # valid documents in this shard

    @property
    def n_words(self) -> int:
        return self.word_hi - self.word_lo


def plan_shards(n_docs: int, n_shards: int) -> list[DocShard]:
    """Partition `n_docs` documents into ≤ `n_shards` word-aligned ranges.

    Words are spread as evenly as possible; the effective shard count is
    clamped to the number of postings words (a shard must own ≥ 1 word).
    Delegates the split to `core.constraint.partition_bounds`, so a
    `PartitionedBudget` over the same (n_docs, n_shards) bounds exactly the
    doc ranges these shards serve.
    """
    bounds = constraint.partition_bounds(n_docs, n_shards)
    shards = []
    for i, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        doc_lo = lo * bitset.WORD
        shards.append(DocShard(
            index=i, word_lo=lo, word_hi=hi, doc_lo=doc_lo,
            n_docs=min(n_docs, hi * bitset.WORD) - doc_lo))
    return shards


def shard_postings(postings: torch.Tensor, n_docs: int, n_shards: int
                   ) -> tuple[list[DocShard], list[torch.Tensor]]:
    """Split int32 postings words [V, Wd] into per-shard column slices.

    Returns `(shards, slices)` where `slices[i]` is the contiguous
    [V, shards[i].n_words] Tier-2 sub-index of shard i, on the postings'
    device.
    """
    shards = plan_shards(n_docs, n_shards)
    return shards, [postings[:, s.word_lo:s.word_hi].contiguous()
                    for s in shards]


def shard_tier_postings(shard_slice: torch.Tensor, shard: DocShard,
                        tier1_docs: np.ndarray) -> tuple[torch.Tensor, int]:
    """Shard-local Tier-1 sub-index: the shard's Tier-2 slice masked to the
    shard's portion of D₁ (on the slice's device), plus the compacted
    words-per-query a re-indexed production Tier-1 of that size would scan
    (0 when D₁ misses the shard, in which case the router need not contact
    the shard at all).
    """
    local = np.asarray(tier1_docs[shard.doc_lo:shard.doc_lo + shard.n_docs],
                       bool)
    t1_bits = bitset.np_pack(local) if shard.n_docs else \
        np.zeros(shard.n_words, np.uint32)
    if t1_bits.shape[0] != shard.n_words:   # last shard: pad to slice width
        t1_bits = np.concatenate(
            [t1_bits, np.zeros(shard.n_words - t1_bits.shape[0], np.uint32)])
    n_local = int(local.sum())
    words = bitset.n_words(n_local) if n_local else 0
    mask = bitset.to_tensor(t1_bits, shard_slice.device)
    return shard_slice & mask[None, :], words
