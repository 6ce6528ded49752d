"""The port's live document ingestion against the reference's.

Every case of `tests/test_ingest.py` but the 4-device mesh mirror, and the
corpus-swap case of `tests/test_frontend.py`, run on both packages (the
port on the CPU) with the same seeded inputs, and the results must be
equal: appended postings, clause and query incidence and corpus rows, the
`AppendDelta`, the feed's documents, re-derived states, tierings, match
sets, `ServeStats`, every `BatchTrace`, window reports, admission
decisions and loadgen reports. Port-only cases: the untouched shards keep
their Tier-2 storage through a corpus swap and the grown last slice is
contiguous; the port's pinned-version oracle (one match per slice) equals
the reference's (concatenate, then match); a device-resident deployment
grows like the host one; the launcher runs with `--device cpu`.

Weights are exact so that every f32 sum is exact in any order (ROADMAP
fault 1): both packages mine the log with its weights as counts over a
power-of-two denominator, and the test-only subclass of each package's
`IngestController` rounds the weights handed to `_admit` (the decayed
traffic weights of the optional offers) and to `_refit` to multiples of
2^-22, as tests/test_torch_stream.py does for refits.
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import cluster as jcluster
from repro import ingest as jingest
from repro import stream as jstream
from repro.data import incidence as jinc
from repro.data import synthetic as jsyn
from repro.serve.engine import TieredEngine as JEngine
from repro_torch import api as tapi
from repro_torch import cluster as tcluster
from repro_torch import ingest as tingest
from repro_torch import stream as tstream
from repro_torch.core import bitset
from repro_torch.core import tiering as tcore_tiering
from repro_torch.data import incidence as tinc
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.launch import ingest as tlaunch
from repro_torch.serve.engine import TieredEngine as TEngine

EXACT = 2.0 ** 22


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


def exact(w):
    """Weights rounded to multiples of 2^-22 (every f32 sum of them exact)."""
    return np.round(np.asarray(w, np.float64) * EXACT) / EXACT


def exact_ingest(cls):
    """`cls` with admission and refit weights rounded to 2^-22."""
    class Exact(cls):
        def _admit(self, problem, state, constraint, delta, weights, irep):
            return super()._admit(problem, state, constraint, delta,
                                  exact(weights), irep)

        def _refit(self, solve_w, raw_w, report):
            super()._refit(exact(solve_w), raw_w, report)
    return Exact


JCtrl = exact_ingest(jingest.IngestController)
TCtrl = exact_ingest(tingest.IngestController)


@pytest.fixture(scope="module")
def mined():
    """tiny, seed 0, dyadic weights, mined by each package, and a cache of
    greedy solves on it (append_docs mutates TieringData and ingest the
    pipeline: every test takes deep copies)."""
    data = []
    for syn, inc in ((jsyn, jinc), (tsyn, tinc)):
        corpus, log = syn.make_tiering_dataset(0, "tiny")
        dyadic(log)
        data.append(inc.build_tiering_data(corpus, log, min_support=1e-3))
    return {"data": tuple(data), "solved": {}}


def fresh(mined):
    return tuple(copy.deepcopy(d) for d in mined["data"])


def pipes(mined, **solve):
    """A greedy-solved pipeline of each package, as a fresh deep copy of
    one solve per budget kind."""
    key = tuple(sorted(solve.items()))
    if key not in mined["solved"]:
        jd, td = fresh(mined)
        kw = dict(budget_frac=0.5, **solve)
        jp = japi.TieringPipeline.from_data(jd).solve("greedy", **kw)
        tp = tapi.TieringPipeline.from_data(td, device="cpu").solve(
            "greedy", **kw)
        assert tp.result.order == jp.result.order
        mined["solved"][key] = (jp, tp)
    return copy.deepcopy(mined["solved"][key])


def feed_docs(pkg, data, t=0, rate=48.0, seed=7):
    feed = pkg.DocumentFeed(log=data.log, vocab_size=data.corpus.vocab_size,
                            rate=rate, seed=seed)
    return list(feed.window(t))


def same_sets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def same_data(t, j):
    np.testing.assert_array_equal(t.postings, j.postings)
    np.testing.assert_array_equal(t.clause_doc_bits, j.clause_doc_bits)
    np.testing.assert_array_equal(t.query_doc_bits, j.query_doc_bits)
    np.testing.assert_array_equal(t.corpus.doc_bits, j.corpus.doc_bits)
    assert t.corpus.doc_tokens == j.corpus.doc_tokens


def same_delta(t, j):
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name))


def grow_both(jp, tp, docs):
    """append + with_doc_block + mandatory re-derivation, in each package."""
    deltas = []
    for pipe, inc in ((jp, jinc), (tp, tinc)):
        delta = inc.append_docs(pipe.data, docs)
        pipe.problem = pipe.problem.with_doc_block(delta.clause_cols,
                                                   delta.n_docs)
        sel = np.nonzero(np.asarray(pipe.result.selected))[0]
        pipe.adopt_selection(pipe.problem.state_for(sel))
        deltas.append(delta)
    return deltas


# -- append-only block appends ------------------------------------------------

def test_append_docs_existing_words_never_move(mined):
    jd, td = fresh(mined)
    docs = feed_docs(tingest, td)
    assert docs == feed_docs(jingest, jd)
    before = td.postings.copy()
    before_cd = td.clause_doc_bits.copy()
    before_qd = td.query_doc_bits.copy()
    delta = tinc.append_docs(td, docs)
    same_delta(delta, jinc.append_docs(jd, docs))
    same_data(td, jd)
    assert delta.word_lo == before.shape[1]
    np.testing.assert_array_equal(td.postings[:, :delta.word_lo], before)
    np.testing.assert_array_equal(
        td.clause_doc_bits[:, :delta.word_lo], before_cd)
    np.testing.assert_array_equal(
        td.query_doc_bits[:, :delta.word_lo], before_qd)
    assert delta.n_holes == delta.word_lo * 32 - delta.doc_lo
    assert 0 <= delta.n_holes < 32
    assert delta.n_docs == delta.word_lo * 32 + delta.n_new


@pytest.mark.parametrize("windows", [1, 3])
def test_append_docs_bit_identical_to_scratch_rebuild(mined, windows):
    """Appended incidence == a full rebuild over the grown corpus, in each
    package, and the two packages' words are equal."""
    jd, td = fresh(mined)
    for t in range(windows):
        docs = feed_docs(tingest, td, t=t)
        same_delta(tinc.append_docs(td, docs), jinc.append_docs(jd, docs))
    same_data(td, jd)
    scratch = tinc.build_tiering_data(td.corpus, td.log, min_support=1e-3)
    assert scratch.clauses == td.clauses
    np.testing.assert_array_equal(scratch.postings, td.postings)
    np.testing.assert_array_equal(scratch.clause_doc_bits, td.clause_doc_bits)
    np.testing.assert_array_equal(scratch.query_doc_bits, td.query_doc_bits)


def test_append_docs_holes_match_nothing(mined):
    _, td = fresh(mined)
    delta = tinc.append_docs(td, feed_docs(tingest, td))
    assert delta.n_holes > 0
    for d in range(delta.doc_lo, delta.word_lo * 32):   # the hole slots
        w, b = d // 32, d % 32
        assert not (td.postings[:, w] >> b & 1).any()
        assert not (td.clause_doc_bits[:, w] >> b & 1).any()
        assert td.corpus.doc_tokens[d] == ()


def test_append_docs_rejects_empty_and_bad_tokens(mined):
    _, td = fresh(mined)
    with pytest.raises(ValueError, match="at least one"):
        tinc.append_docs(td, [])
    with pytest.raises(ValueError, match="outside vocab"):
        tinc.append_docs(td, [(0, td.corpus.vocab_size)])
    with pytest.raises(ValueError, match="outside vocab"):
        tinc.append_docs(td, [(-1,)])
    same_data(td, mined["data"][1])          # a refused append changes nothing


def test_append_docs_on_device_words_equals_host(mined):
    """A deployment held as int32 words (postings and the problem's clause
    bits tensors, no query incidence, no corpus rows) grows its postings on
    their device with the host case's bits; its clause bits, which only
    with_doc_block grows, are dropped (None, never left at the old width),
    and the controller's order (append, with_doc_block, adopt) gives the
    host case's clause bits."""
    _, host = fresh(mined)
    _, dev = fresh(mined)
    problem = tapi.TieringPipeline.from_data(dev, device="cpu").problem
    dev.postings = bitset.to_tensor(dev.postings, "cpu")
    dev.clause_doc_bits = problem.clause_doc_bits
    dev.query_doc_bits = None
    dev.corpus.doc_bits = None
    for t in range(2):
        docs = feed_docs(tingest, host, t=t)
        want = tinc.append_docs(host, docs)
        got = tinc.append_docs(dev, docs)
        same_delta(got, want)
        assert dev.clause_doc_bits is None
        assert dev.postings.shape[1] == got.word_hi
        problem = problem.with_doc_block(got.clause_cols, got.n_docs)
        dev.clause_doc_bits = problem.clause_doc_bits
    np.testing.assert_array_equal(bitset.to_numpy(dev.postings), host.postings)
    np.testing.assert_array_equal(bitset.to_numpy(problem.clause_doc_bits),
                                  host.clause_doc_bits)
    assert dev.query_doc_bits is None and dev.corpus.doc_bits is None
    assert dev.corpus.doc_tokens == host.corpus.doc_tokens


def test_device_append_outside_the_controller_leaves_no_stale_bits(mined):
    """append_docs called directly on a device deployment: its clause bits
    go to None, so a tiering cannot be derived from the old width; once the
    grown problem's are adopted, the tiering equals the host case's."""
    tp = pipes(mined)[1]
    host = copy.deepcopy(tp.data)
    dev = tp.data
    dev.postings = bitset.to_tensor(dev.postings, "cpu")
    dev.clause_doc_bits = tp.problem.clause_doc_bits
    docs = feed_docs(tingest, host)
    delta = tinc.append_docs(dev, docs)
    tinc.append_docs(host, docs)
    sel = np.asarray(tp.result.selected)
    assert dev.clause_doc_bits is None
    with pytest.raises(TypeError):
        tcore_tiering.ClauseTiering.from_selection(dev, sel)
    dev.clause_doc_bits = tp.problem.with_doc_block(
        delta.clause_cols, delta.n_docs).clause_doc_bits
    got = tcore_tiering.ClauseTiering.from_selection(dev, sel)
    want = tcore_tiering.ClauseTiering.from_selection(host, sel)
    np.testing.assert_array_equal(got.tier1_docs, want.tier1_docs)
    assert len(got.tier1_docs) == delta.n_docs


def test_with_doc_block_checks_and_shares_the_query_side(mined):
    jp, tp = pipes(mined)
    docs = feed_docs(tingest, tp.data)
    (jdelta, tdelta) = [inc.append_docs(p.data, docs)
                        for p, inc in ((jp, jinc), (tp, tinc))]
    grown = tp.problem.with_doc_block(tdelta.clause_cols, tdelta.n_docs)
    jgrown = jp.problem.with_doc_block(jdelta.clause_cols, jdelta.n_docs)
    np.testing.assert_array_equal(bitset.to_numpy(grown.clause_doc_bits),
                                  np.asarray(jgrown.clause_doc_bits))
    assert grown.n_docs == jgrown.n_docs == tdelta.n_docs
    assert grown.clause_query_bits is tp.problem.clause_query_bits
    assert grown.query_weights is tp.problem.query_weights
    on_device = tp.problem.with_doc_block(
        bitset.to_tensor(tdelta.clause_cols, "cpu"), tdelta.n_docs)
    assert torch.equal(on_device.clause_doc_bits, grown.clause_doc_bits)
    with pytest.raises(ValueError, match="rows"):
        tp.problem.with_doc_block(tdelta.clause_cols[1:], tdelta.n_docs)
    with pytest.raises(ValueError, match="append-only"):
        tp.problem.with_doc_block(tdelta.clause_cols, tp.problem.n_docs - 1)


# -- stale pre-append states ----------------------------------------------------

def test_stale_state_rejected_by_name_and_state_for_rederives(mined):
    """After append + `with_doc_block`, the pre-append state is refused with
    the reference's texts, and `state_for` re-derives the reference's state
    over the grown incidence."""
    jp, tp = pipes(mined)
    prev = tp.result.state
    docs = feed_docs(tingest, tp.data)
    for pipe, inc in ((jp, jinc), (tp, tinc)):
        delta = inc.append_docs(pipe.data, docs)
        pipe.problem = pipe.problem.with_doc_block(delta.clause_cols,
                                                   delta.n_docs)
    problem = tp.problem
    w = np.asarray(tp.log.train_weights)
    with pytest.raises(ValueError, match="state_for"):
        tstream.check_state_width(problem, prev)
    with pytest.raises(ValueError, match="stale SolverState"):
        tstream.prune_state(problem, prev, weights=w)
    with pytest.raises(ValueError, match="stale warm-start state"):
        tp.refit(w, state=prev)
    sel = np.nonzero(prev.selected.numpy())[0]
    state = problem.state_for(sel)
    jstate = jp.problem.state_for(sel)
    np.testing.assert_array_equal(state.selected.numpy(),
                                  prev.selected.numpy())
    np.testing.assert_array_equal(bitset.to_numpy(state.covered_d),
                                  np.asarray(jstate.covered_d))
    np.testing.assert_array_equal(bitset.to_numpy(state.covered_q),
                                  np.asarray(jstate.covered_q))
    assert float(state.g_used) == float(jstate.g_used)
    assert int(state.covered_d.shape[0]) == problem.wd
    tp.adopt_selection(state)
    jp.adopt_selection(jstate)
    tp.refit(w, state=state)
    jp.refit(w, state=jstate)
    assert tp.result.order == jp.result.order


def test_mandatory_admission_covers_appended_docs(mined):
    """Every appended doc matched by a SELECTED clause lands in Tier 1 of
    the re-derived tiering, and the tiering is the reference's."""
    jp, tp = pipes(mined)
    _, delta = grow_both(jp, tp, feed_docs(tingest, tp.data))
    tiering, jt = tp.tiering(), jp.tiering()
    np.testing.assert_array_equal(tiering.tier1_docs, jt.tier1_docs)
    np.testing.assert_array_equal(tiering.clause_vocab_bits,
                                  jt.clause_vocab_bits)
    sel = np.nonzero(tp.result.selected)[0]
    matched_block = bitset.np_unpack(
        np.bitwise_or.reduce(delta.clause_cols[sel], axis=0),
        delta.n_docs - delta.word_lo * 32)
    t1_block = tiering.tier1_docs[delta.word_lo * 32:]
    assert matched_block.any(), "feed produced no mandatory admissions"
    assert np.all(t1_block[matched_block]), \
        "a doc matched by a selected clause is missing from Tier 1"
    assert tp.verify()


# -- stale corpus versions ------------------------------------------------------

def test_swap_with_stale_tiering_raises_named_error(mined):
    jp, tp = pipes(mined)
    fleets = [p.deploy_cluster(n_shards=2, t1_replicas=1) for p in (jp, tp)]
    stale = tp.tiering()                       # pre-append doc count
    grow_both(jp, tp, feed_docs(tingest, tp.data))
    for fleet, pipe in zip(fleets, (jp, tp)):
        fleet.swap_corpus(pipe.data.postings, pipe.data.n_docs,
                          pipe.tiering(), immediate=True)
    assert fleets[1].corpus_version == fleets[0].corpus_version == 1
    with pytest.raises(tcluster.StaleCorpusError, match="rebuild it"):
        fleets[1].swap_tiering(stale)
    q = tp.log.queries[:48]
    same_sets(fleets[1].serve(q), fleets[0].serve(q))
    same_sets(fleets[1].serve(q), fleets[1].serve_reference(q))


def test_prepared_buffer_from_old_version_raises_named_error(mined):
    """A buffer prepared BEFORE a corpus swap must not roll out after it."""
    jp, tp = pipes(mined)
    fleet = tp.deploy_cluster(n_shards=2, t1_replicas=1)
    buf = fleet.prepare_tiering(tp.tiering())
    grow_both(jp, tp, feed_docs(tingest, tp.data))
    fleet.swap_corpus(tp.data.postings, tp.data.n_docs, tp.tiering(),
                      immediate=True)
    with pytest.raises(tcluster.StaleCorpusError, match="corpus version"):
        fleet.swap_tiering(buf)


def test_engine_swap_corpus_rejects_shrinking(mined):
    _, tp = pipes(mined)
    engine = TEngine(tp.data.postings, tp.tiering(), tp.data.n_docs,
                     device="cpu")
    with pytest.raises(ValueError, match="append-only"):
        engine.swap_corpus(tp.data.postings[:, :-1],
                           tp.data.n_docs - 40, tp.tiering())
    with pytest.raises(ValueError, match="append-only"):
        engine.swap_corpus(tp.data.postings, tp.data.n_docs - 1,
                           tp.tiering())
    assert engine.corpus_version == 0


def test_engine_swap_corpus_equals_reference(mined):
    """The engine's stop-the-world swap: host words or a device tensor
    (adopted as it is), the reference's version, width and match sets."""
    jp, tp = pipes(mined)
    jeng = JEngine(jp.data.postings, jp.tiering(), jp.data.n_docs)
    teng = tp.deploy()
    grow_both(jp, tp, feed_docs(tingest, tp.data))
    assert jeng.swap_corpus(jp.data.postings, jp.data.n_docs,
                            jp.tiering()) == \
        teng.swap_corpus(tp.data.postings, tp.data.n_docs, tp.tiering())
    assert teng.corpus_version == jeng.corpus_version == 1
    assert teng.stats.full_words_per_query == \
        jeng.stats.full_words_per_query == tp.data.postings.shape[1]
    q = tp.log.queries[:64]
    got = teng.serve(q)
    same_sets(got, jeng.serve(q))
    same_sets(got, teng.serve_reference(q))
    assert teng.stats.to_dict() == jeng.stats.to_dict()
    grown = bitset.to_tensor(tp.data.postings, "cpu")
    teng.swap_corpus(grown, tp.data.n_docs, tp.tiering())
    assert teng.postings_t2 is grown and teng.corpus_version == 2


# -- the admission policy -------------------------------------------------------

def _policy_trace(pkg):
    policy = pkg.AdmissionPolicy(observe=4, quantile=0.5, window=16)
    out = [policy.threshold()]
    for i in range(4):                            # observe phase: never admit
        out.append(policy.offer(i, ratio=100.0, feasible=True))
    out.append(policy.threshold())
    for i, r, f in ((4, 50.0, True), (5, 200.0, False), (6, 200.0, True)):
        out.append(policy.offer(i, ratio=r, feasible=f))
    return policy, out


def test_admission_policy_observe_then_accept():
    policy, got = _policy_trace(tingest)
    jpolicy, want = _policy_trace(jingest)
    assert got == want
    assert [dataclasses.astuple(d) for d in policy.decisions] == \
        [dataclasses.astuple(d) for d in jpolicy.decisions]
    assert got[0] == float("inf") and got[5] == 100.0
    assert [d.reason for d in policy.decisions] == \
        ["observe"] * 4 + ["below", "infeasible", "admitted"]
    assert policy.n_infeasible == 1
    assert policy.n_admitted == 1 and policy.n_offers == 7
    assert "admitted=1" in policy.summary()
    assert policy.summary() == jpolicy.summary()


def test_admission_policy_trailing_window_and_floor():
    out = []
    for pkg in (tingest, jingest):
        policy = pkg.AdmissionPolicy(observe=2, quantile=0.0, window=4,
                                     min_ratio=10.0)
        for r in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
            policy.offer(0, ratio=r, feasible=True)
        # window=4 keeps ratios {3..6}; quantile 0 -> min of window, floored
        assert policy.threshold() == 10.0
        assert not policy.offer(0, ratio=9.0, feasible=True)
        assert policy.offer(0, ratio=10.0, feasible=True)
        out.append([dataclasses.astuple(d) for d in policy.decisions])
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="quantile"):
        tingest.AdmissionPolicy(quantile=1.5)


# -- the seeded feed --------------------------------------------------------------

def test_document_feed_deterministic_and_in_vocab(mined):
    _, td = fresh(mined)
    feeds = [tingest.DocumentFeed(log=td.log,
                                  vocab_size=td.corpus.vocab_size,
                                  rate=32.0, seed=3) for _ in range(2)]
    wins_a = [feeds[0].window(t) for t in range(4)]
    wins_b = [feeds[1].window(t) for t in reversed(range(4))][::-1]
    assert wins_a == wins_b                       # seed-deterministic A/B
    docs = [d for w in wins_a for d in w]
    assert docs
    for d in docs:
        assert d == tuple(sorted(set(d))) and len(d) >= 1
        assert all(0 <= t < td.corpus.vocab_size for t in d)
    assert feeds[0].n_emitted == len(docs)


@pytest.mark.parametrize("seed,rate,correlation", [(0, 32.0, 0.6),
                                                   (3, 200.0, 0.9),
                                                   (11, 64.0, 0.0),
                                                   (5, 48.0, 1.0)])
def test_document_feed_equals_reference(mined, seed, rate, correlation):
    """The same documents as the reference's feed for the same (seed, t),
    with the log's weights and with a drifting window's probs."""
    jd, td = fresh(mined)
    sim = tstream.TrafficSimulator(td.log, "rotate", seed=seed, n_windows=3,
                                   queries_per_window=64)
    probs = [None] + [w.probs for w in sim.windows()]
    kw = dict(rate=rate, correlation=correlation, seed=seed)
    tf = tingest.DocumentFeed(log=td.log, vocab_size=td.corpus.vocab_size,
                              **kw)
    jf = jingest.DocumentFeed(log=jd.log, vocab_size=jd.corpus.vocab_size,
                              **kw)
    for t, p in enumerate(probs):
        assert tf.window(t, p) == jf.window(t, p)
    assert tf.n_emitted == jf.n_emitted > 0


# -- end-to-end ingest loops --------------------------------------------------------

TRAFFIC = dict(budget_split="traffic", n_shards=2)


def ingest_both(mined, *, fleet_kw=None, split=None, n_windows=2, qpw=128,
                **kw):
    """`run_ingest` in each package through the rounding controllers, on
    the engine (fleet_kw None) or on a fleet of each package, after a
    greedy solve under `split` (per-shard caps: `partition_gain` offers;
    none: `coverage_gain` offers)."""
    jp, tp = pipes(mined, **(split or {}))
    out = []
    for pkg, spkg, ctrl_cls, pipe in ((jingest, jstream, JCtrl, jp),
                                      (tingest, tstream, TCtrl, tp)):
        engine = pipe.deploy_cluster(**fleet_kw) if fleet_kw else None
        feed = pkg.DocumentFeed(log=pipe.log,
                                vocab_size=pipe.corpus.vocab_size,
                                rate=32.0, correlation=0.6, seed=0)
        sim = spkg.TrafficSimulator(pipe.log, "rotate", seed=0,
                                    n_windows=n_windows,
                                    queries_per_window=qpw)
        ctrl = ctrl_cls(pipe, feed=feed, admission=pkg.AdmissionPolicy(),
                        verify_ingest=True, verify_swaps=True, engine=engine,
                        **kw)
        out.append((ctrl.run(sim), ctrl, pipe))
    (jrep, jctrl, jp), (trep, tctrl, tp) = out
    assert report_dict(trep) == report_dict(jrep)
    assert [dataclasses.astuple(d) for d in tctrl.admission.decisions] == \
        [dataclasses.astuple(d) for d in jctrl.admission.decisions]
    assert trep.summary() == jrep.summary()
    assert trep.admission_summary == jrep.admission_summary
    same_data(tp.data, jp.data)
    return (jrep, jctrl, jp), (trep, tctrl, tp)


def report_dict(rep):
    """`IngestReport.to_dict` without its wall clocks."""
    d = rep.to_dict()
    for w in d["windows"]:
        w.pop("ingest_seconds")
        w["serve"].pop("refit_seconds")
    return d


def test_run_ingest_single_engine_verified(mined):
    """The global budget: `coverage_gain` offers."""
    _, (rep, ctrl, pipe) = ingest_both(mined)
    assert rep.failed_windows() == 0
    assert rep.n_ingested > 0 and rep.n_admitted > 0
    assert rep.windows[-1].corpus_version == len(rep.windows)
    assert ctrl.engine.corpus_version == len(rep.windows)
    assert all(w.ingest_ok for w in rep.windows)
    assert pipe.problem.n_docs == pipe.data.n_docs == rep.windows[-1].n_docs


def test_run_ingest_rolling_fleet_verified(mined):
    (jrep, jctrl, jp), (rep, ctrl, pipe) = ingest_both(
        mined, fleet_kw=dict(n_shards=2, t1_replicas=2, t2_replicas=2))
    assert rep.n_admitted > 0
    fleet, jfleet = ctrl.engine, jctrl.engine
    assert rep.failed_windows() == 0
    assert fleet.consistency_ok()
    assert fleet.corpus_version == jfleet.corpus_version == len(rep.windows)
    assert [dataclasses.astuple(x) for x in fleet.trace] == \
        [dataclasses.astuple(x) for x in jfleet.trace]
    assert fleet.stats.to_dict() == jfleet.stats.to_dict()
    fleet.drain_rollout()
    jfleet.drain_rollout()
    sample = pipe.log.queries[:64]
    got = fleet.serve(sample)
    same_sets(got, fleet.serve_reference(
        sample, corpus_version=fleet.corpus_version))
    same_sets(got, jfleet.serve(sample))


def test_run_ingest_stop_the_world_fleet_equals_reference(mined):
    """Per-shard caps: `partition_gain` offers."""
    _, (rep, ctrl, _) = ingest_both(
        mined, fleet_kw=dict(n_shards=2, t1_replicas=1, t2_replicas=1),
        split=TRAFFIC, rollout="stw")
    assert rep.rollout == "stw" and rep.failed_windows() == 0
    assert ctrl.engine.consistency_ok()


def test_serve_reference_unknown_version_raises(mined):
    _, tp = pipes(mined)
    fleet = tp.deploy_cluster(n_shards=2, t1_replicas=1)
    q = tp.log.queries[:4]
    with pytest.raises(KeyError, match="no live buffer"):
        fleet.serve_reference(q, corpus_version=99)
    with pytest.raises(ValueError, match="not both"):
        fleet.serve_reference(q, corpus_version=0, generation=0)
    same_sets(fleet.serve_reference(q, corpus_version=0),
              fleet.serve_reference(q))
    same_sets(fleet.serve_reference(q, generation=0),
              fleet.serve_reference(q))


# -- the rolling corpus swap ------------------------------------------------------

def rolling_fleets(mined, n_shards=3, **kw):
    """A fleet of each package mid-way through a rolling corpus swap."""
    jp, tp = pipes(mined)
    fleets = [p.deploy_cluster(n_shards=n_shards, **kw) for p in (jp, tp)]
    before = [(t.data_ptr(), t.shape) for t in fleets[1]._t2_dev]
    grow_both(jp, tp, feed_docs(tingest, tp.data))
    for fleet, pipe in zip(fleets, (jp, tp)):
        fleet.swap_corpus(pipe.data.postings, pipe.data.n_docs,
                          pipe.tiering())
    return jp, tp, fleets, before


def test_untouched_shards_keep_their_tier2_storage(mined):
    jp, tp, (jf, tf), before = rolling_fleets(mined, t1_replicas=2,
                                              t2_replicas=2)
    assert [dataclasses.astuple(s) for s in tf.shards] == \
        [dataclasses.astuple(s) for s in jf.shards]
    assert tf._t2_content == jf._t2_content
    *kept, last = tf._t2_dev
    assert [(t.data_ptr(), t.shape) for t in kept] == before[:-1]
    assert last.is_contiguous() and last.data_ptr() != before[-1][0]
    np.testing.assert_array_equal(
        bitset.to_numpy(last), tp.data.postings[:, tf.shards[-1].word_lo:])
    q = tp.log.queries[:40]
    while tf.router.rollout is not None:
        same_sets(tf.serve(q), jf.serve(q))
    jf.drain_rollout()
    for s in tf.shards[:-1]:                  # never drained, never copied
        for r in tf.router.t2[s.index]:
            assert r.postings.data_ptr() == before[s.index][0]
            assert r.n_installs == 0
    for r in tf.router.t2[tf.shards[-1].index]:
        assert r.postings.data_ptr() == last.data_ptr()
    assert [dataclasses.astuple(x) for x in tf.trace] == \
        [dataclasses.astuple(x) for x in jf.trace]
    assert tf.consistency_ok()


def test_pinned_version_oracle_equals_reference(mined):
    """Mid-rollout, the port's per-slice oracle at each live corpus version
    == the reference's concatenate-then-match == the port's own match over
    the concatenated slices."""
    jp, tp, (jf, tf), _ = rolling_fleets(mined, t1_replicas=1,
                                         t2_replicas=1)
    q = tp.log.queries[:64]
    seen = set()
    while tf.router.rollout is not None:
        got = tf.serve(q)
        same_sets(got, jf.serve(q))
        v = tf.trace[-1].corpus_version
        assert v == jf.trace[-1].corpus_version
        seen.add(v)
        want = tf.serve_reference(q, corpus_version=v)
        same_sets(want, jf.serve_reference(q, corpus_version=v))
        same_sets(got, want)
        buf = max((b for b in tf.router._buffers.values()
                   if b.corpus_version == v), key=lambda b: b.generation)
        whole = ops.match_batch(torch.cat(list(buf.t2_postings), dim=1),
                                tf.router._tokens(q))
        same_sets(want, bitset.rows_to_indices(whole, buf.n_docs))
        for g in tf.router._buffers:
            same_sets(tf.serve_reference(q, generation=g),
                      jf.serve_reference(q, generation=g))
    assert seen == {0, 1}, seen


def test_router_cache_exact_across_rolling_corpus_swap(mined):
    jp, tp = pipes(mined)
    fleets = [p.deploy_cluster(n_shards=2, t1_replicas=2, cache=True)
              for p in (jp, tp)]
    jf, tf = fleets
    queries = tp.log.queries[:48]
    for _ in range(2):
        same_sets(tf.serve(queries), jf.serve(queries))
    assert tf.cache.stats.hits > 0               # warm before the swap
    grow_both(jp, tp, feed_docs(tingest, tp.data))
    for fleet, pipe in zip(fleets, (jp, tp)):
        fleet.swap_corpus(pipe.data.postings, pipe.data.n_docs,
                          pipe.tiering())
    batches = 0
    while tf.router.rollout is not None and batches < 64:
        got = tf.serve(queries)
        same_sets(got, jf.serve(queries))
        v = tf.trace[-1].corpus_version
        same_sets(got, tf.serve_reference(queries, corpus_version=v))
        batches += 1
    assert tf.router.rollout is None and jf.router.rollout is None
    assert tf.consistency_ok()
    got = tf.serve(queries)                      # warm at the new version
    same_sets(got, tf.serve_reference(queries))
    same_sets(got, jf.serve(queries))
    assert tf.cache.snapshot() == jf.cache.snapshot()
    assert tf.stats.to_dict() == jf.stats.to_dict()


# -- loadgen: ingest traffic ------------------------------------------------------

@pytest.fixture(scope="module")
def loadgen_plan(mined):
    jp, tp = pipes(mined)
    jf, tf = [p.deploy_cluster(n_shards=2, t1_replicas=2, t2_replicas=2)
              for p in (jp, tp)]
    plan = tcluster.ClusterPlan.of_cluster(tf)
    assert dataclasses.astuple(plan) == \
        dataclasses.astuple(jcluster.ClusterPlan.of_cluster(jf))
    elig = tf.classify(tp.log.queries[:256])
    np.testing.assert_array_equal(elig, jf.classify(jp.log.queries[:256]))
    return plan, jcluster.ClusterPlan.of_cluster(jf), elig


def test_loadgen_ingest_qps_zero_is_bit_compatible(loadgen_plan):
    plan, jplan, elig = loadgen_plan
    base = tcluster.run_loadgen(plan, elig, n_queries=800, seed=0)
    zero = tcluster.run_loadgen(plan, elig, n_queries=800, seed=0,
                                ingest_qps=0.0)
    assert base == zero                 # same rng draws, same report
    assert base.n_ingest_events == 0 and base.stw_delayed_queries == 0
    assert zero.to_dict() == jcluster.run_loadgen(
        jplan, elig, n_queries=800, seed=0, ingest_qps=0.0).to_dict()


def test_loadgen_stw_outage_delays_queries(loadgen_plan):
    plan, jplan, elig = loadgen_plan
    kw = dict(n_queries=2000, seed=0, rollout_at_s=0.02, swap_ms=5.0,
              ingest_qps=100.0)
    rolling = tcluster.run_loadgen(plan, elig, rollout_mode="rolling", **kw)
    stw = tcluster.run_loadgen(plan, elig, rollout_mode="stw", **kw)
    assert stw.stw_delayed_queries > 0 and rolling.stw_delayed_queries == 0
    assert stw.p99_ms > rolling.p99_ms  # one fleet-wide stop vs rolling
    assert stw.n_ingest_events == rolling.n_ingest_events > 0
    for mode, rep in (("rolling", rolling), ("stw", stw)):
        assert rep.to_dict() == jcluster.run_loadgen(
            jplan, elig, rollout_mode=mode, **kw).to_dict()
    with pytest.raises(ValueError, match="rollout_mode"):
        tcluster.run_loadgen(plan, elig, rollout_mode="bogus")


# -- reports and the launcher ---------------------------------------------------------

def test_reports_roundtrip(mined):
    _, tp = pipes(mined)
    rep = tingest.run_ingest(tp, n_windows=2, queries_per_window=64,
                             arrivals_per_window=16.0, verify=True)
    back = tingest.IngestReport.from_dict(rep.to_dict())
    assert back.to_dict() == rep.to_dict()
    assert [w.line() for w in back.windows] == [w.line() for w in rep.windows]
    assert back.summary() == rep.summary()


def test_controller_validates_rollout_and_budget_policy(mined):
    _, tp = pipes(mined)
    feed = tingest.DocumentFeed(log=tp.log, vocab_size=tp.corpus.vocab_size)
    with pytest.raises(ValueError, match="rollout"):
        tingest.IngestController(tp, feed=feed, rollout="bogus")
    with pytest.raises(ValueError, match="budget_policy"):
        tingest.IngestController(tp, feed=feed, budget_policy="bogus")


def test_ingest_launcher_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "ingest", "--scale", "tiny", "--windows", "2", "--verify",
        "--device", "cpu", "--obs-dir", ""])
    tlaunch.main()                      # a failed check is a SystemExit
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert "verified: 2 versioned parity checks ok" in out
    assert "triple-consistent" in out and "failed=0" in out


def test_ingest_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["ingest", "--scale", "tiny",
                                     "--obs-dir", ""])
    with pytest.raises((RuntimeError, AssertionError)):
        tlaunch.main()
