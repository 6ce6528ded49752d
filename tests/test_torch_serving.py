"""The slice as a whole: the port's pipeline -> deploy -> serve against the
reference's, on the quickstart's 256 queries (tiny, seed 0).

Both pipelines mine the same log with its weights as counts over a
power-of-two denominator (see test_torch_solvers), so both select the same
clauses; the engines must then agree on ψ, on every match set and on the
serving statistics.
"""
import math

import numpy as np
import pytest

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import TieredEngine


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


@pytest.fixture(scope="module")
def engines():
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    jp.mine(min_support=1e-3).solve("optpes", budget_frac=0.5)
    tp.mine(min_support=1e-3).solve("optpes", budget_frac=0.5)
    queries = [jp.log.queries[i] for i in np.random.default_rng(0).choice(
        jp.log.n_queries, 256)]
    return jp, tp, queries


def _same_sets(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def test_pipeline_serves_like_the_reference(engines):
    jp, tp, queries = engines
    assert tp.verify() and jp.verify()
    assert tp.coverage() == jp.coverage()
    je, te = jp.deploy(), tp.deploy()
    np.testing.assert_array_equal(te.classify(queries), je.classify(queries))
    got, want = te.serve(queries), je.serve(queries)
    assert _same_sets(got, want)
    assert _same_sets(te.serve_reference(queries), je.serve_reference(queries))
    assert _same_sets(got, te.serve_reference(queries))
    assert te.stats.to_dict() == je.stats.to_dict()
    assert 0 < te.stats.n_tier1 < len(queries)       # both tiers served


def test_converted_tiering_serves_like_the_reference(engines):
    """A reference tiering carried across with convert.tiering_from_numpy."""
    jp, _, queries = engines
    jt = jp.tiering()
    tiering = convert.tiering_from_numpy(jt.clauses, jt.clause_vocab_bits,
                                         jt.tier1_docs, jt.vocab_size)
    te = TieredEngine(jp.data.postings, tiering, jp.data.n_docs, device="cpu")
    je = jp.deploy()
    assert _same_sets(te.serve(queries), je.serve(queries))
    assert te.stats.to_dict() == je.stats.to_dict()


def test_swap_and_empty_batch(engines):
    jp, tp, queries = engines
    te, je = tp.deploy(), jp.deploy()
    assert te.serve([]) == [] and te.stats.n_queries == 0
    empty = convert.tiering_from_numpy(
        [], np.zeros((0, tp.tiering().clause_vocab_bits.shape[1]), np.uint32),
        np.zeros(tp.data.n_docs, bool), tp.data.vocab_size)
    assert te.swap_tiering(empty) == 1 and te.generation == 1
    assert not te.classify(queries).any()
    assert _same_sets(te.serve(queries), je.serve_reference(queries))
    assert te.stats.n_tier1 == 0
    assert te.swap_tiering(te.prepare_tiering(tp.tiering())) == 2
    assert _same_sets(te.serve(queries), je.serve(queries))


def test_serve_launcher_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--scale", "tiny", "--requests",
                                     "256", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "offline solve on cpu" in out and "256 requests" in out
