"""Incidence-structure builders: postings, match sets, clause incidence.

The port of `repro.data.incidence` (host-side numpy, the same words; the
incidence builders gather postings rows for all sets at once). Turns the
host-side corpus/query log into the packed uint32 operands the SCSK engine
consumes; `core.problem.SCSKProblem` moves them to the device as int32
words:

  postings_bits     uint32 [V, Wd]   token -> doc bitset (the inverted index)
  clause_doc_bits   uint32 [C, Wd]   m(c) per clause  (paper eq. 1, AND of postings)
  clause_query_bits uint32 [C, Wq]   {q : c ⊆ q} per clause
  query_doc_bits    uint32 [Nq, Wd]  m(q) per unique query (flow baselines)
  clause_doc_ids    int32  [C, M]    padded+sorted m(c) id lists (sparse path)

`append_docs` grows those structures by a whole-word document block
(`repro_torch.ingest`): existing words are never rewritten, so any column
slice taken before the append stays bit-identical afterwards. The block's
columns are computed from the block's documents alone, and the postings
may be int32 words on a device, where they are grown without a host copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.data.synthetic import Corpus, QueryLog


def _scatter_bits(shape: tuple[int, int], rows: np.ndarray,
                  cols: np.ndarray) -> np.ndarray:
    """uint32 words [shape[0], shape[1]] with bit `cols[i]` of row
    `rows[i]` set (what `np_pack` of the bool matrix gives)."""
    out = np.zeros(shape, np.uint32)
    cols = np.asarray(cols, np.int64)
    np.bitwise_or.at(out, (np.asarray(rows, np.int64), cols >> 5),
                     np.uint32(1) << (cols & 31).astype(np.uint32))
    return out


def _token_doc_pairs(doc_tokens) -> tuple[np.ndarray, np.ndarray]:
    """(token, doc) id pairs of every posting, as two int64 arrays."""
    tok = np.fromiter((int(v) for t in doc_tokens for v in t), np.int64)
    doc = np.repeat(np.arange(len(doc_tokens)),
                    np.asarray([len(t) for t in doc_tokens], np.int64))
    return tok, doc


def build_postings(corpus: Corpus) -> np.ndarray:
    """Packed postings lists: bit d of row v set iff v ∈ doc d."""
    tok, doc = _token_doc_pairs(corpus.doc_tokens)
    return _scatter_bits((corpus.vocab_size, bitset.n_words(corpus.n_docs)),
                         tok, doc)


def clause_doc_incidence(postings: np.ndarray, clauses: list[tuple[int, ...]],
                         n_docs: int) -> np.ndarray:
    """m(c) per clause, packed [C, Wd]: the AND of the clause terms'
    postings rows (an empty clause matches every doc), the bits past
    `n_docs` cleared. One row gather per term position, over all clauses
    at once."""
    out = np.full((len(clauses), postings.shape[1]), 0xFFFFFFFF, np.uint32)
    width = max((len(c) for c in clauses), default=0)
    table = np.full((len(clauses), width), -1, np.int64)
    for i, c in enumerate(clauses):
        table[i, :len(c)] = c
    for k in range(width):
        has = np.nonzero(table[:, k] >= 0)[0]
        out[has] &= postings[table[has, k]]
    return out & bitset.np_pack(np.ones(n_docs, dtype=bool))[None, :]


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
    return clause_doc_incidence(postings, log.queries, n_docs)


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
    """Everything the solvers and baselines need, in host numpy. A
    deployment held on a device gives `postings` and `clause_doc_bits` as
    its int32 words there and None for what it does not keep (the query
    incidence, the corpus rows)."""
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


@dataclasses.dataclass(frozen=True)
class AppendDelta:
    """What one `append_docs` call added, in block coordinates.

    The block is word-aligned: it starts at word `word_lo` (doc id
    `word_lo * 32`), so up to 31 hole slots pad the previous tail word
    first. Holes are permanent empty documents (`()` token sets, zero bits
    in every incidence structure): no existing postings word is rewritten,
    and they never match a clause or a query. `clause_cols` is the
    clause x block incidence as host uint32 words, ready for
    `SCSKProblem.with_doc_block`.
    """
    doc_lo: int                # global id of the first appended slot (hole or doc)
    n_holes: int               # alignment padding slots before the real docs
    n_new: int                 # real documents appended
    word_lo: int               # first appended postings word (inclusive)
    word_hi: int               # one past the last appended word == new Wd
    clause_cols: np.ndarray    # uint32 [C, word_hi - word_lo] block m(c) columns
    n_docs: int                # corpus.n_docs after the append (incl. holes)


def append_docs(data: "TieringData", docs: list[tuple[int, ...]]) -> AppendDelta:
    """Append a word-aligned document block to every incidence structure.

    Mutates `data` (corpus, postings, clause_doc_bits, query_doc_bits) in
    place and returns the `AppendDelta` describing the block, as the
    reference's `append_docs` does, with bit-identical words. The block
    starts at the next word boundary (hole slots fill the tail partial
    word); its columns are computed from its own documents only, O((V + C +
    Nq) · block_words), and concatenated, so every pre-existing word keeps
    its exact bits.

    A deployment held on a device has int32 `postings` words there: they
    are grown with `torch.cat` on that device. Its `clause_doc_bits`, when a
    tensor, are the problem's own: `SCSKProblem.with_doc_block` grows them
    from `clause_cols`, and they are set to None here rather than left at
    the old width (the caller adopts the grown problem's). A
    `query_doc_bits` or `corpus.doc_bits` of None is not kept and stays
    None.
    """
    if not docs:
        raise ValueError("append_docs needs at least one document")
    corpus = data.corpus
    word_lo = data.postings.shape[1]
    doc_lo = word_lo * bitset.WORD
    n_holes = doc_lo - corpus.n_docs
    n_new = len(docs)
    n_docs_new = doc_lo + n_new
    word_hi = bitset.n_words(n_docs_new)

    for t in docs:
        bad = [v for v in t if not 0 <= int(v) < corpus.vocab_size]
        if bad:
            raise ValueError(f"document tokens {bad} outside vocab "
                             f"[0, {corpus.vocab_size})")
    new_docs = [tuple(sorted(set(int(v) for v in t))) for t in docs]
    corpus.doc_tokens.extend([()] * n_holes)
    corpus.doc_tokens.extend(new_docs)

    # block postings [V, wb]: bit j of row v set iff v ∈ the block's doc j
    tok, col = _token_doc_pairs(new_docs)
    blk_postings = _scatter_bits((corpus.vocab_size, word_hi - word_lo),
                                 tok, col)

    if corpus.doc_bits is not None:
        # corpus doc_bits rows: holes are all-zero rows, then the packed docs
        width = corpus.doc_bits.shape[1]
        corpus.doc_bits = np.concatenate([
            corpus.doc_bits, np.zeros((n_holes, width), np.uint32),
            _scatter_bits((n_new, width), col, tok)])

    # incidence columns over the block only (block doc ids are local)
    clause_cols = clause_doc_incidence(blk_postings, data.clauses, n_new)
    if isinstance(data.postings, torch.Tensor):
        data.postings = torch.cat(
            [data.postings, bitset.to_tensor(blk_postings, data.postings.device)],
            dim=1)
    else:
        data.postings = np.concatenate([data.postings, blk_postings], axis=1)
    if isinstance(data.clause_doc_bits, torch.Tensor):
        data.clause_doc_bits = None     # the problem's; with_doc_block grows them
    else:
        data.clause_doc_bits = np.concatenate(
            [data.clause_doc_bits, clause_cols], axis=1)
    if data.query_doc_bits is not None:
        data.query_doc_bits = np.concatenate(
            [data.query_doc_bits,
             query_doc_incidence(blk_postings, data.log, n_new)], axis=1)
    return AppendDelta(doc_lo=doc_lo - n_holes, n_holes=n_holes, n_new=n_new,
                       word_lo=word_lo, word_hi=word_hi,
                       clause_cols=clause_cols, n_docs=corpus.n_docs)


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
