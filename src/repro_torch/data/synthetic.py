"""Synthetic corpus + heavy-tailed query-distribution generator.

Mirrors the statistics the paper reports for its commercial-search data at a
CPU-tractable scale: a Zipfian vocabulary, documents as term sets, and a query
distribution with (a) a Zipfian head, and (b) a heavy tail such that a
substantial fraction of *test* queries never appear in the *training* log —
exactly the regime where the paper's clause method beats query-selection
(flow) methods, cf. paper §2.3 and Fig. 5.

Everything here is host-side numpy preprocessing (the paper's analogue is
Lucene indexing); the packed operands are produced by data/incidence.py.
A copy of `repro.data.synthetic`: the same seed draws the same corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import bitset


@dataclasses.dataclass
class Corpus:
    doc_tokens: list[tuple[int, ...]]   # sorted term ids per doc
    doc_bits: np.ndarray                # packed uint32 [n_docs, Wv] over vocab
    vocab_size: int

    @property
    def n_docs(self) -> int:
        return len(self.doc_tokens)


@dataclasses.dataclass
class QueryLog:
    """Unique queries with empirical train/test probabilities.

    train_weights/test_weights are empirical probabilities over the union of
    unique queries; a query unseen in train has train_weights == 0 (the
    "novel traffic" the paper's method must generalize to).
    """
    queries: list[tuple[int, ...]]
    query_bits: np.ndarray              # packed uint32 [Nq, Wv] over vocab
    train_weights: np.ndarray           # f64 [Nq], sums to 1
    test_weights: np.ndarray            # f64 [Nq], sums to 1
    n_train_samples: int
    n_test_samples: int

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    def novel_test_mass(self) -> float:
        """Fraction of test traffic on queries unseen in training."""
        return float(self.test_weights[self.train_weights == 0].sum())


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def make_corpus(
    rng: np.random.Generator,
    *,
    vocab_size: int = 2000,
    n_docs: int = 20000,
    doc_len_mean: float = 8.0,
    zipf_a: float = 1.05,
) -> Corpus:
    probs = _zipf_probs(vocab_size, zipf_a)
    # shuffle so token id is not rank (more realistic hashing)
    perm = rng.permutation(vocab_size)
    probs = probs[perm]
    docs: list[tuple[int, ...]] = []
    lengths = np.maximum(2, rng.poisson(doc_len_mean, size=n_docs))
    for i in range(n_docs):
        k = int(min(lengths[i], vocab_size))
        toks = rng.choice(vocab_size, size=k, replace=False, p=probs)
        docs.append(tuple(sorted(int(t) for t in set(toks.tolist()))))
    bits = np.zeros((n_docs, vocab_size), dtype=bool)
    for i, d in enumerate(docs):
        bits[i, list(d)] = True
    return Corpus(doc_tokens=docs, doc_bits=bitset.np_pack(bits), vocab_size=vocab_size)


def make_query_log(
    rng: np.random.Generator,
    corpus: Corpus,
    *,
    pool_size: int = 30000,
    n_train: int = 200000,
    n_test: int = 70000,
    max_query_len: int = 4,
    zipf_a: float = 0.9,
) -> QueryLog:
    """Build a query pool by sub-sampling document term sets (non-empty match
    sets guaranteed), Zipf-weight the pool, and draw iid train/test logs."""
    n_docs = corpus.n_docs
    pool: dict[tuple[int, ...], None] = {}
    while len(pool) < pool_size:
        need = pool_size - len(pool)
        doc_idx = rng.integers(0, n_docs, size=need * 2)
        sizes = rng.integers(1, max_query_len + 1, size=need * 2)
        for di, sz in zip(doc_idx, sizes):
            d = corpus.doc_tokens[int(di)]
            if len(d) == 0:
                continue
            sz = int(min(sz, len(d)))
            q = tuple(sorted(int(t) for t in rng.choice(d, size=sz, replace=False)))
            pool[q] = None
            if len(pool) >= pool_size:
                break
    queries = list(pool.keys())
    pool_probs = _zipf_probs(len(queries), zipf_a)
    pool_probs = pool_probs[rng.permutation(len(queries))]

    train_counts = rng.multinomial(n_train, pool_probs)
    test_counts = rng.multinomial(n_test, pool_probs)
    keep = (train_counts + test_counts) > 0
    queries = [q for q, k in zip(queries, keep) if k]
    train_counts = train_counts[keep]
    test_counts = test_counts[keep]

    bits = np.zeros((len(queries), corpus.vocab_size), dtype=bool)
    for i, q in enumerate(queries):
        bits[i, list(q)] = True

    return QueryLog(
        queries=queries,
        query_bits=bitset.np_pack(bits),
        train_weights=train_counts / max(1, n_train),
        test_weights=test_counts / max(1, n_test),
        n_train_samples=n_train,
        n_test_samples=n_test,
    )


def make_tiering_dataset(seed: int = 0, scale: str = "small"):
    """One-call dataset factory. Scales: tiny (tests), small (benches),
    medium (solver benchmarks)."""
    rng = np.random.default_rng(seed)
    presets = {
        "tiny": dict(vocab_size=64, n_docs=200, doc_len_mean=6.0,
                     pool=400, n_train=4000, n_test=1500),
        "small": dict(vocab_size=800, n_docs=4000, doc_len_mean=8.0,
                      pool=6000, n_train=60000, n_test=20000),
        "medium": dict(vocab_size=2000, n_docs=20000, doc_len_mean=8.0,
                       pool=30000, n_train=200000, n_test=70000),
    }
    p = presets[scale]
    corpus = make_corpus(rng, vocab_size=p["vocab_size"], n_docs=p["n_docs"],
                         doc_len_mean=p["doc_len_mean"])
    log = make_query_log(rng, corpus, pool_size=p["pool"],
                         n_train=p["n_train"], n_test=p["n_test"])
    return corpus, log
