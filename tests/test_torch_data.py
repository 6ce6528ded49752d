"""repro_torch.data against repro.data: the same seed gives byte-equal
corpora, query logs, mined clauses and packed incidence structures."""
import numpy as np
import pytest

from repro.data import incidence as jinc
from repro.data import mining as jmin
from repro.data import synthetic as jsyn
from repro_torch.data import incidence as tinc
from repro_torch.data import mining as tmin
from repro_torch.data import synthetic as tsyn


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("scale", ["tiny", "small"])
def test_tiering_data_byte_equal(scale):
    jc, jl = jsyn.make_tiering_dataset(0, scale)
    tc, tl = tsyn.make_tiering_dataset(0, scale)
    assert tc.doc_tokens == jc.doc_tokens and _same(tc.doc_bits, jc.doc_bits)
    assert tl.queries == jl.queries and _same(tl.query_bits, jl.query_bits)
    assert _same(tl.train_weights, jl.train_weights)
    assert _same(tl.test_weights, jl.test_weights)
    jd = jinc.build_tiering_data(jc, jl, min_support=1e-3)
    td = tinc.build_tiering_data(tc, tl, min_support=1e-3)
    assert td.clauses == jd.clauses
    assert _same(td.clause_support, jd.clause_support)
    for name in ("postings", "clause_doc_bits", "clause_query_bits",
                 "query_doc_bits"):
        assert _same(getattr(td, name), getattr(jd, name)), name
    assert td.vocab_size == jc.vocab_size


def test_fpgrowth_and_id_lists_match_reference():
    rng = np.random.default_rng(3)
    tx = [tuple(sorted(set(rng.integers(0, 12, size=rng.integers(1, 5)).tolist())))
          for _ in range(200)]
    w = list(rng.random(200) / 200)
    assert tmin.fpgrowth(tx, w, 0.01) == jmin.fpgrowth(tx, w, 0.01)
    assert tmin.brute_force_frequent(tx, w, 0.01) == \
        jmin.brute_force_frequent(tx, w, 0.01)
    rows = rng.integers(0, 2 ** 32, size=(6, 3), dtype=np.uint32)
    assert _same(tinc.padded_id_lists(rows, 90), jinc.padded_id_lists(rows, 90))


@pytest.mark.parametrize("n_docs", [1, 31, 32, 33, 70])
def test_incidence_builders_edge_cases(n_docs):
    """build_postings and the vectorised clause/query incidence against the
    reference's per-set loop: an empty clause, clauses of every length,
    repeated tokens in a document, empty documents, a partial last word."""
    rng = np.random.default_rng(n_docs)
    docs = [tuple(rng.integers(0, 9, size=rng.integers(0, 6)).tolist())
            for _ in range(n_docs)]
    corpus = tsyn.Corpus(doc_tokens=docs, doc_bits=None, vocab_size=9)
    post = tinc.build_postings(corpus)
    assert _same(post, jinc.build_postings(corpus))
    sets = [(), (3,), (1, 2), (0, 4, 8), (2, 5, 6, 7), (8,)]
    assert _same(tinc.clause_doc_incidence(post, sets, n_docs),
                 jinc.clause_doc_incidence(post, sets, n_docs))
    assert tinc.clause_doc_incidence(post, [], n_docs).shape == \
        (0, post.shape[1])
    log = type("Log", (), {"queries": sets[1:]})()
    assert _same(tinc.query_doc_incidence(post, log, n_docs),
                 jinc.query_doc_incidence(post, log, n_docs))
