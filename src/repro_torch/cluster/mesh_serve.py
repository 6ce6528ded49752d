"""Fused scatter-gather serving over a shard mesh.

The host router issues one dispatch per (tier, shard) per batch; on a shard
mesh the shards are owned by mesh entries, and the whole serve path runs
as one program over the `"shard"` axis:

  1. replicated classify — every entry runs the packed clause-subset-test
     kernel (`ops.clause_match`) on the full batch, so the ψ^clause decision
     needs no broadcast;
  2. owner-local match — each entry AND-matches the batch against the
     RESIDENT slices of the shards it owns, one `ops.tier_match` launch per
     shard: ψ's per-query choice selects the Tier-1 or the Tier-2 row of
     each token inside the kernel (the reference's `select_rows_match` on
     its stacked [2V, wmax] tiers); eligible queries' rows on a shard whose
     local D₁ is empty are zeroed, as the host router never contacts such a
     shard for them;
  3. gather — every entry's blocks are copied to the first entry and
     concatenated there in word order. Shards own disjoint word ranges
     that tile [0, w_total), so the result is bit-identical to the host
     path's placement.

The port's counterpart of `repro.cluster.mesh_serve`, driven by one
process: an entry's work is launched on its device in turn, and the gather
is a tensor copy to the first entry's device (a peer copy between cards;
on one card, where every entry is `cuda:0`, no copy at all, and the
entries' launches run in series on one stream). The reference merges with
a ring of `ppermute` hops because every device of an SPMD program runs the
same program and ends with the whole result; with one controller only the
first entry's words are read, so the port gathers there instead of
replicating the output on every entry. No host sync happens inside the
program; the caller's read-back of the words is the one sync point.

Operands live in a `MeshRouteTable` built from ONE `ClusterTieringBuffer`:
its Tier-1 sub-indexes and its pinned corpus snapshot (shard plan, Tier-2
slices, global width), so a table never pairs tiers from different corpus
versions and a mid-roll replica can never leak a mixed-version slice into
the fused path. The table references the buffer's per-shard tensors where
they already lie on the owning entry's device and copies only the shards
the mesh puts elsewhere: on one card it adds no bytes. Each shard keeps its
own width, so nothing is padded and there are no pad shards (an entry may
own fewer shards, or none); a block is never wider than its shard, so no
zero tail can reach a neighbour's words.

The reference buckets batches to powers of two so that JAX compiles once
per bucket, and pipelines 512-query chunks to overlap its host packing with
the device; the port compiles nothing and its launches are already
asynchronous, so a batch goes through whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.distributed import Mesh, blocks
from repro_torch.kernels import ops
from repro_torch.serve import matching


@dataclasses.dataclass(frozen=True)
class OwnedShard:
    """One shard's resident operands on the mesh entry that owns it."""
    word_lo: int                  # first global word the shard owns
    t2: torch.Tensor              # int32 [V, n_words]: the pinned Tier-2 slice
    t1: torch.Tensor | None       # int32 [V, n_words]: the Tier-1 sub-index;
    #                               None when no query may take it (D₁
    #                               misses the shard, or the Tier-2 gap)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshRouteTable:
    """Operands of the fused serve for ONE (ψ generation, corpus version,
    fleet topology, mesh): per mesh entry, its device, ψ's clause words
    there and the shards it owns."""
    devices: tuple[torch.device, ...]
    clause_bits: tuple[torch.Tensor, ...]      # int32 [K, Wv] per entry
    owned: tuple[tuple[OwnedShard, ...], ...]  # per entry
    w_total: int                               # global packed match width
    vocab_size: int
    bytes_added: int      # device bytes the table copied (0: all referenced)

    @property
    def n_clauses(self) -> int:
        return int(self.clause_bits[0].shape[0])


def build_table(buf, mesh: Mesh, *, use_t1: bool = True) -> MeshRouteTable:
    """The fused serve's operands for `buf` on `mesh`.

    Every operand comes from the buffer: its Tier-1 sub-indexes (the same
    bits a committed replica holds) and its pinned corpus snapshot. With
    `use_t1=False` (the mid-rollout gap, served entirely at the buffer's
    corpus version) ψ's clause set is empty and every query takes the
    buffer's Tier-2 slices.
    """
    added = 0

    def place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        nonlocal added
        if t.device == dev:
            return t                  # resident on its owner: referenced
        added += t.numel() * t.element_size()
        return t.to(dev)

    lo = 0
    for s in buf.shards:
        if s.word_lo != lo:
            raise ValueError(f"shard {s.index} starts at word {s.word_lo}, "
                             f"not {lo}: the shards must tile the corpus")
        lo = s.word_hi
    if lo != buf.w_total:
        raise ValueError(f"the shards cover {lo} words of {buf.w_total}")
    vocab = buf.tiering.vocab_size
    cbits = buf.clause_bits if use_t1 else \
        torch.zeros((0, bitset.n_words(vocab)), dtype=torch.int32)
    owned, clause_bits = [], []
    for dev, own in zip(mesh.devices, blocks(len(buf.shards), mesh.size)):
        clause_bits.append(place(cbits, dev))
        owned.append(tuple(
            OwnedShard(
                word_lo=s.word_lo, t2=place(buf.t2_postings[s.index], dev),
                t1=place(buf.shard_postings[s.index], dev)
                if use_t1 and buf.shard_nonempty(s.index) else None)
            for s in (buf.shards[i] for i in own)))
    return MeshRouteTable(
        devices=mesh.devices, clause_bits=tuple(clause_bits),
        owned=tuple(owned), w_total=buf.w_total, vocab_size=vocab,
        bytes_added=added)


def local_match(table: MeshRouteTable, tokens: torch.Tensor):
    """Steps 1-2 on every entry: ψ and the owner-local match. Returns
    `(elig, blocks)`, per entry its bool [B] eligibility and its
    (word_lo, int32 words [B, n_words]) blocks, all on its device."""
    b = int(tokens.shape[0])
    eligs, blks = [], []
    for dev, cbits, owned in zip(table.devices, table.clause_bits,
                                 table.owned):
        toks = tokens.to(dev)
        if table.n_clauses:
            elig = ops.clause_match(
                bitset.pack_tokens(toks, table.vocab_size), cbits)
        else:
            elig = torch.zeros(b, dtype=torch.bool, device=dev)
        blk = []
        for sh in owned:
            if sh.t1 is not None:
                m = ops.tier_match(sh.t1, sh.t2, elig, toks)
            else:
                m = ops.tier_match(sh.t2, sh.t2, None, toks)
                if table.n_clauses:      # D₁ misses the shard: no matches
                    m = m.masked_fill_(elig[:, None], 0)
            blk.append((sh.word_lo, m))
        eligs.append(elig)
        blks.append(blk)
    return eligs, blks


def gather(devices, blks) -> torch.Tensor:
    """Step 3: every entry's blocks, copied to the first entry and
    concatenated in word order: int32 words [B, w_total] there."""
    parts = sorted((p for blk in blks for p in blk), key=lambda p: p[0])
    return torch.cat([m.to(devices[0]) for _, m in parts], dim=1)


def serve_fused(table: MeshRouteTable, queries
                ) -> tuple[torch.Tensor, np.ndarray]:
    """Serve one batch through the fused program on the table's entries.

    Returns `(int32 words [B, w_total] on the first entry's device, host
    bool eligibility [B])` — bit-identical to the host router's
    scatter-gather placement.
    """
    dev0 = table.devices[0]
    toks = torch.from_numpy(matching.pad_token_batch(queries)).to(dev0)
    eligs, blks = local_match(table, toks)
    return gather(table.devices, blks), eligs[0].cpu().numpy()
