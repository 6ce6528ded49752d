"""Incidence-structure builders: postings, match sets, clause incidence.

A copy of `repro.data.incidence` (host-side numpy) without the ingest
slice's `append_docs`. Turns the host-side corpus/query log into the packed
uint32 operands the SCSK engine consumes; `core.problem.SCSKProblem`
moves them to the device as int32 words:

  postings_bits     uint32 [V, Wd]   token -> doc bitset (the inverted index)
  clause_doc_bits   uint32 [C, Wd]   m(c) per clause  (paper eq. 1, AND of postings)
  clause_query_bits uint32 [C, Wq]   {q : c ⊆ q} per clause
  query_doc_bits    uint32 [Nq, Wd]  m(q) per unique query (flow baselines)
  clause_doc_ids    int32  [C, M]    padded+sorted m(c) id lists (sparse path)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bitset
from repro_torch.data.synthetic import Corpus, QueryLog


def build_postings(corpus: Corpus) -> np.ndarray:
    """Packed postings lists: bit d of row v set iff v ∈ doc d."""
    n_docs = corpus.n_docs
    bits = np.zeros((corpus.vocab_size, n_docs), dtype=bool)
    for d, toks in enumerate(corpus.doc_tokens):
        bits[list(toks), d] = True
    return bitset.np_pack(bits)


def match_bits(postings: np.ndarray, clause: tuple[int, ...], n_docs: int) -> np.ndarray:
    """m(clause) as a packed bitset: AND of the clause terms' postings."""
    out = np.full(postings.shape[1], 0xFFFFFFFF, dtype=np.uint32)
    for t in clause:
        out &= postings[t]
    # clear padding bits beyond n_docs
    pad_mask = bitset.np_pack(np.ones(n_docs, dtype=bool))
    return out & pad_mask


def clause_doc_incidence(postings: np.ndarray, clauses: list[tuple[int, ...]],
                         n_docs: int) -> np.ndarray:
    return np.stack([match_bits(postings, c, n_docs) for c in clauses]) \
        if clauses else np.zeros((0, postings.shape[1]), np.uint32)


def clause_query_incidence(
    query_bits: np.ndarray,            # packed [Nq, Wv]
    clauses: list[tuple[int, ...]],
    vocab_size: int,
    chunk: int = 512,
) -> np.ndarray:
    """Packed [C, Wq]: bit q of row c set iff c ⊆ q. Chunked subset test."""
    nq = query_bits.shape[0]
    cbits = np.zeros((len(clauses), vocab_size), dtype=bool)
    for i, c in enumerate(clauses):
        cbits[i, list(c)] = True
    cpk = bitset.np_pack(cbits)                       # [C, Wv]
    out = np.zeros((len(clauses), nq), dtype=bool)
    for s in range(0, len(clauses), chunk):
        blk = cpk[s:s + chunk]                        # [b, Wv]
        sub = (query_bits[None, :, :] & blk[:, None, :]) == blk[:, None, :]
        out[s:s + chunk] = sub.all(axis=-1)
    return bitset.np_pack(out)


def query_doc_incidence(postings: np.ndarray, log: QueryLog, n_docs: int) -> np.ndarray:
    """m(q) per unique query, packed [Nq, Wd] (used by flow baselines)."""
    return np.stack([match_bits(postings, q, n_docs) for q in log.queries])


def padded_id_lists(rows_bits: np.ndarray, n_bits: int,
                    pad_to: int | None = None) -> np.ndarray:
    """Packed rows -> int32 [R, M] sorted id lists padded with -1."""
    lists = [bitset.np_to_indices(r, n_bits) for r in rows_bits]
    m = pad_to or max((len(x) for x in lists), default=1)
    out = np.full((len(lists), max(m, 1)), -1, dtype=np.int32)
    for i, x in enumerate(lists):
        out[i, :len(x)] = x          # np.nonzero is already sorted
    return out


@dataclasses.dataclass
class TieringData:
    """Everything the solvers and baselines need, in host numpy."""
    corpus: Corpus
    log: QueryLog
    postings: np.ndarray             # [V, Wd]
    clauses: list[tuple[int, ...]]
    clause_support: np.ndarray       # f64 [C] empirical P[c ⊆ q]
    clause_doc_bits: np.ndarray      # [C, Wd]
    clause_query_bits: np.ndarray    # [C, Wq]
    query_doc_bits: np.ndarray       # [Nq, Wd]

    @property
    def n_docs(self) -> int:
        return self.corpus.n_docs

    @property
    def n_queries(self) -> int:
        return self.log.n_queries

    @property
    def vocab_size(self) -> int:
        return self.corpus.vocab_size


def build_tiering_data(corpus: Corpus, log: QueryLog, *, min_support: float,
                       max_clause_len: int = 4,
                       max_clauses: int | None = None) -> TieringData:
    from repro_torch.data import mining
    # mine with head-room, THEN keep the top-support clauses: fpgrowth's
    # max_items stops recursion mid-mining (an arbitrary subset, not the
    # most frequent patterns)
    mined = mining.fpgrowth(
        log.queries, list(log.train_weights), min_support,
        max_len=max_clause_len,
        max_items=None if max_clauses is None else 10 * max_clauses)
    clauses = sorted(mined, key=lambda c: (-mined[c], c))
    if max_clauses is not None:
        clauses = clauses[:max_clauses]
    postings = build_postings(corpus)
    return TieringData(
        corpus=corpus,
        log=log,
        postings=postings,
        clauses=clauses,
        clause_support=np.array([mined[c] for c in clauses]),
        clause_doc_bits=clause_doc_incidence(postings, clauses, corpus.n_docs),
        clause_query_bits=clause_query_incidence(
            log.query_bits, clauses, corpus.vocab_size),
        query_doc_bits=query_doc_incidence(postings, log, corpus.n_docs),
    )
