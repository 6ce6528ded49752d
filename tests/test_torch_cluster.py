"""The port's sharded fleet (host path) and front-end against the reference's.

Every case of `tests/test_cluster.py`, and those of `tests/test_frontend.py`
that need neither ingest nor the mesh, run on both packages (the port on
the CPU) with the same inputs: the reference's tiering, carried across with
`convert.tiering_from_numpy`, over the same postings. Shard plans, slices
and Tier-1 sub-indexes, match sets, `ServeStats`, every `BatchTrace`, the
replicas' counters, cache keys and contents, and loadgen reports must be
equal. The controller-driven runs mine the log with its weights as counts
over a power-of-two denominator and round the refit weights to multiples
of 2^-22 (exact f32 sums, ROADMAP fault 1; see tests/test_torch_stream.py).
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import cluster as jcluster
from repro import obs as jobs
from repro import stream as jstream
from repro.cluster import frontend as jfrontend
from repro.core import SOLVERS
from repro.core.tiering import ClauseTiering as JTiering
from repro.serve import matching as jmatching
from repro.serve.engine import TieredEngine as JEngine
from repro_torch import api as tapi
from repro_torch import cluster as tcluster
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch import stream as tstream
from repro_torch.cluster import frontend as tfrontend
from repro_torch.core import bitset
from repro_torch.launch import cluster as tlaunch
from repro_torch.serve import matching as tmatching
from repro_torch.serve.engine import TieredEngine as TEngine

ROOT = Path(__file__).resolve().parents[1]


def _tierings(data, problem, budget_frac=0.5, solver="optpes"):
    """The reference's tiering and its copy for the port."""
    r = SOLVERS[solver](problem, int(data.n_docs * budget_frac))
    jt = JTiering.from_selection(data, r.selected)
    return jt, convert.tiering_from_numpy(jt.clauses, jt.clause_vocab_bits,
                                          jt.tier1_docs, jt.vocab_size)


def _fleets(data, tierings, **kw):
    jt, tt = tierings
    return (jcluster.TieredCluster(data.postings, jt, data.n_docs, **kw),
            tcluster.TieredCluster(data.postings, tt, data.n_docs,
                                   device="cpu", **kw))


def _same_sets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _replicas(fleet):
    return [(r.tier, r.shard.index, r.generation, r.content, r.draining,
             r.n_batches, r.n_queries, r.words_scanned, r.n_installs,
             r.words_per_query)
            for groups in (fleet.router.t1, fleet.router.t2)
            for g in groups for r in g]


def _same_fleet(t, j):
    """Stats, every retained BatchTrace and every replica's counters."""
    assert t.stats.to_dict() == j.stats.to_dict()
    assert [dataclasses.astuple(x) for x in t.trace] == \
        [dataclasses.astuple(x) for x in j.trace]
    assert _replicas(t) == _replicas(j)
    assert t.generation == j.generation
    assert t.router.live_generations() == j.router.live_generations()
    assert t.consistency_ok() and j.consistency_ok()


def _serve_both(fleets, batch):
    jf, tf = fleets
    got, want = tf.serve(batch), jf.serve(batch)
    _same_sets(got, want)
    _same_sets(got, tf.serve_reference(batch))
    return got


# -- shard planning --------------------------------------------------------------

@pytest.mark.parametrize("n_docs,n_shards", [(200, 1), (200, 2), (200, 4),
                                             (33, 4), (31, 3), (1, 2),
                                             (20000, 7)])
def test_plan_shards_equals_reference(n_docs, n_shards):
    got = tcluster.plan_shards(n_docs, n_shards)
    want = jcluster.plan_shards(n_docs, n_shards)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert sum(s.n_docs for s in got) == n_docs
    assert all(s.n_words >= 1 for s in got)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 5])
def test_shard_postings_and_tier_postings_equal_reference(tiny_data,
                                                          tiny_problem,
                                                          n_shards):
    jt, tt = _tierings(tiny_data, tiny_problem)
    post = bitset.to_tensor(tiny_data.postings, "cpu")
    tshards, tslices = tcluster.shard_postings(post, tiny_data.n_docs,
                                               n_shards)
    jshards, jslices = jcluster.shard_postings(tiny_data.postings,
                                               tiny_data.n_docs, n_shards)
    assert tshards == [tcluster.DocShard(*dataclasses.astuple(s))
                       for s in jshards]
    for s, a, b in zip(tshards, tslices, jslices):
        assert a.is_contiguous()
        np.testing.assert_array_equal(bitset.to_numpy(a), b)
        tp, tw = tcluster.shard_tier_postings(a, s, tt.tier1_docs)
        jp, jw = jcluster.shard_tier_postings(b, jshards[s.index],
                                              jt.tier1_docs)
        assert tw == jw and tp.is_contiguous()
        np.testing.assert_array_equal(bitset.to_numpy(tp), jp)
    np.testing.assert_array_equal(
        bitset.to_numpy(torch.cat(tslices, 1)), tiny_data.postings)
    np.testing.assert_array_equal(
        bitset.to_numpy(tmatching.tier_postings(post, tt.tier1_docs)),
        jmatching.tier_postings(tiny_data.postings, jt.tier1_docs))


def test_pack_query_bits_bytes_equal_reference(tiny_data):
    queries = tiny_data.log.queries[:200] + [(), (3, 3, 1), (63,)]
    got = tmatching.pack_query_bits(queries, tiny_data.corpus.vocab_size)
    want = jmatching.pack_query_bits(queries, tiny_data.corpus.vocab_size)
    assert got.dtype == np.uint32 and got.shape == want.shape
    assert [r.tobytes() for r in got] == [r.tobytes() for r in want]


# -- ψ: the batched classifier == the per-query reference ---------------------------

def test_fleet_classifier_equals_per_query_psi(tiny_data, tiny_problem):
    tierings = _tierings(tiny_data, tiny_problem)
    jf, tf = _fleets(tiny_data, tierings, n_shards=2)
    want = tierings[0].classify_queries(tiny_data.log.query_bits)
    np.testing.assert_array_equal(tf.classify(tiny_data.log.queries), want)
    np.testing.assert_array_equal(jf.classify(tiny_data.log.queries), want)
    assert tf.classify([]).shape == (0,)


@pytest.mark.parametrize("seed", range(8))
def test_batched_classifier_random_logs(seed):
    """Random logs: the fleet's ψ == the reference's batched classifier ==
    the per-query subset test == brute force."""
    rng = np.random.default_rng(seed)
    vocab, n_queries, n_clauses = (int(rng.integers(1, 150)),
                                   int(rng.integers(1, 80)),
                                   int(rng.integers(0, 40)))
    qbits = rng.random((n_queries, vocab)) < 0.25
    cbits = rng.random((n_clauses, vocab)) < 0.08
    queries = [tuple(int(t) for t in np.nonzero(row)[0]) for row in qbits]
    clauses = [tuple(int(t) for t in np.nonzero(row)[0]) for row in cbits]
    tt = convert.tiering_from_numpy(clauses, bitset.np_pack(cbits),
                                    np.zeros(32, bool), vocab)
    fleet = tcluster.TieredCluster(np.zeros((vocab, 1), np.uint32), tt, 32,
                                   n_shards=1, device="cpu")
    got = fleet.classify(queries)
    want = jmatching.classify_batch(tt.clause_vocab_bits, queries, vocab)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got,
                                  tt.classify_queries(bitset.np_pack(qbits)))
    brute = np.array([any(set(c) <= set(q) for c in clauses) for q in queries])
    np.testing.assert_array_equal(got, brute)


# -- exhaustive cluster-vs-oracle exactness --------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_cluster_equals_single_tier_and_reference(tiny_data, tiny_problem,
                                                  n_shards, replicas):
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=n_shards, t1_replicas=replicas,
                     t2_replicas=replicas)
    queries = tiny_data.log.queries
    for s in range(0, len(queries), 128):
        _serve_both(fleets, queries[s:s + 128])
    jf, tf = fleets
    _same_fleet(tf, jf)
    st = tf.stats
    assert st.n_queries == len(queries)
    if n_shards > 1:
        assert 0 < st.n_tier1 < st.n_queries and st.cost_saving > 0.0


def test_every_replica_holds_contiguous_postings(tiny_data, tiny_problem):
    _, tf = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                    n_shards=3, t1_replicas=2, t2_replicas=2)
    reps = [r for groups in (tf.router.t1, tf.router.t2)
            for g in groups for r in g]
    assert all(r.postings.is_contiguous() for r in reps)
    assert all(p.is_contiguous()
               for p in tf.router._buffers[0].shard_postings)
    # a strided view handed to a replica is copied once, contiguous
    view = tf.postings_t2[:, 1:3]
    assert not view.is_contiguous()
    rep = tcluster.ShardReplica(2, tf.shards[0], view, 2)
    assert rep.postings.is_contiguous()
    rep.commit(view, 2, 1, content=99)
    assert rep.postings.is_contiguous() and rep.n_installs == 1


def test_cluster_stats_match_single_engine(tiny_data, tiny_problem):
    jt, tt = _tierings(tiny_data, tiny_problem)
    engine = TEngine(tiny_data.postings, tt, tiny_data.n_docs, device="cpu")
    jengine = JEngine(tiny_data.postings, jt, tiny_data.n_docs)
    _, fleet = _fleets(tiny_data, (jt, tt), n_shards=1, t1_replicas=1)
    queries = tiny_data.log.queries[:256]
    engine.serve(queries)
    jengine.serve(queries)
    fleet.serve(queries)
    for f in ("n_tier1", "tier1_words", "tier2_words", "full_words_per_query"):
        assert getattr(fleet.stats, f) == getattr(engine.stats, f) == \
            getattr(jengine.stats, f)


# -- rolling swaps -----------------------------------------------------------------

def test_rolling_swap_exact_and_unmixed_mid_run(tiny_data, tiny_problem):
    t_new = _tierings(tiny_data, tiny_problem, budget_frac=0.25)
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=2)
    jf, tf = fleets
    queries = tiny_data.log.queries
    _serve_both(fleets, queries[:64])
    assert tf.swap_tiering(t_new[1]) == jf.swap_tiering(t_new[0]) == 1
    mixed, batches = False, 0
    while tf.router.rollout is not None and batches < 64:
        lo = 64 * (batches % 5)
        _serve_both(fleets, queries[lo:lo + 64])
        mixed |= len(tf.router.live_generations()) > 1
        batches += 1
    assert tf.router.rollout is None and jf.router.rollout is None
    assert mixed and tf.router.live_generations() == {1}
    _serve_both(fleets, queries[:64])
    _same_fleet(tf, jf)
    for t in tf.trace:
        assert all(g == t.psi_generation for g in t.t1_generations)


def test_single_replica_rollout_falls_back_to_tier2(tiny_data, tiny_problem):
    t_new = _tierings(tiny_data, tiny_problem, budget_frac=0.25)
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=1)
    jf, tf = fleets
    queries = tiny_data.log.queries
    _serve_both(fleets, queries[:64])
    tf.swap_tiering(t_new[1])
    jf.swap_tiering(t_new[0])
    fallback = batches = 0
    while tf.router.rollout is not None and batches < 64:
        _serve_both(fleets, queries[:64])
        fallback += tf.trace[-1].psi_generation == -1
        batches += 1
    assert fallback > 0
    _serve_both(fleets, queries[:64])
    assert tf.trace[-1].psi_generation == 1 and tf.trace[-1].n_tier1 > 0
    _same_fleet(tf, jf)


def test_swap_accepts_a_prepared_buffer_and_immediate(tiny_data, tiny_problem):
    t_new = _tierings(tiny_data, tiny_problem, budget_frac=0.25)
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=2)
    jf, tf = fleets
    tbuf, jbuf = tf.prepare_tiering(t_new[1]), jf.prepare_tiering(t_new[0])
    assert tbuf.shard_content == jbuf.shard_content
    assert tbuf.shard_words == jbuf.shard_words
    assert tf.swap_tiering(tbuf, immediate=True) == \
        jf.swap_tiering(jbuf, immediate=True) == 1
    assert tf.router.rollout is None and tf.describe() == jf.describe()
    _serve_both(fleets, tiny_data.log.queries[:64])
    _same_fleet(tf, jf)
    with pytest.raises(tcluster.StaleCorpusError, match="docs"):
        tf.prepare_tiering(dataclasses.replace(
            t_new[1], tier1_docs=t_new[1].tier1_docs[:-1]))


def test_scoped_rollout_leaves_untouched_shards_alone(tiny_data, tiny_problem):
    data = tiny_data
    tierings = _tierings(data, tiny_problem, solver="greedy")
    tiering = tierings[0]
    fleets = _fleets(data, tierings, n_shards=2, t1_replicas=2)
    jf, tf = fleets
    s1 = tf.shards[1]
    sel = np.zeros(len(data.clauses), bool)
    sel[[data.clauses.index(c) for c in tiering.clauses]] = True
    t_new = None
    for j in np.nonzero(sel)[0]:
        row = data.clause_doc_bits[j]
        if bitset.np_popcount(row[:s1.word_lo]) == 0 and \
                bitset.np_popcount(row) > 0:
            trial = sel.copy()
            trial[j] = False
            cand = JTiering.from_selection(data, trial)
            if np.array_equal(cand.tier1_docs[:s1.doc_lo],
                              tiering.tier1_docs[:s1.doc_lo]) and \
                    not np.array_equal(cand.tier1_docs, tiering.tier1_docs):
                t_new = cand
                break
    assert t_new is not None
    queries = data.log.queries
    _serve_both(fleets, queries[:64])
    installs0 = [r.n_installs for g in tf.router.t1 for r in g]
    tf.swap_tiering(convert.tiering_from_numpy(
        t_new.clauses, t_new.clause_vocab_bits, t_new.tier1_docs,
        t_new.vocab_size))
    jf.swap_tiering(t_new)
    assert tf.router.rollout.n_carried == jf.router.rollout.n_carried == 2
    batches = 0
    while tf.router.rollout is not None and batches < 30:
        lo = 64 * (batches % 4)
        _serve_both(fleets, queries[lo:lo + 64])
        assert tf.trace[-1].psi_generation != -1
        batches += 1
    delta = [a - b for a, b in zip(
        [r.n_installs for g in tf.router.t1 for r in g], installs0)]
    assert delta == [0, 0, 1, 1]
    _same_fleet(tf, jf)


def test_full_swap_still_rolls_every_replica(tiny_data, tiny_problem):
    t_new = _tierings(tiny_data, tiny_problem, budget_frac=0.25)
    jf, tf = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=2)
    tf.swap_tiering(t_new[1])
    jf.swap_tiering(t_new[0])
    assert tf.router.rollout.n_carried == 0
    assert tf.router.rollout.run_to_completion() == \
        jf.router.rollout.run_to_completion() == 4


# -- the controller drives a cluster ---------------------------------------------------

EXACT = 2.0 ** 22


def _dyadic(log):
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


def _exact_ctrl(cls):
    class Exact(cls):
        def _refit(self, solve_w, raw_w, report):
            solve_w = np.round(np.asarray(solve_w) * EXACT) / EXACT
            super()._refit(solve_w, raw_w, report)
            self.orders = getattr(self, "orders", []) + [
                list(self.pipe.result.order)]
    return Exact


@pytest.fixture(scope="module")
def dyadic_pipes():
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    _dyadic(jp.log)
    _dyadic(tp.log)
    return jp.mine(min_support=1e-3).data, tp.mine(min_support=1e-3).data


@pytest.mark.parametrize("split,cache", [(None, False), ("traffic", True)])
def test_controller_drives_cluster_like_the_reference(dyadic_pipes, split,
                                                      cache):
    jd, td = dyadic_pipes
    kw = dict(budget_frac=0.5, budget_split=split,
              n_shards=2 if split else None)
    jp = japi.TieringPipeline.from_data(jd).solve("greedy", **kw)
    tp = tapi.TieringPipeline.from_data(td, device="cpu").solve("greedy", **kw)
    assert tp.result.order == jp.result.order
    runs = []
    for pkg, spkg, pipe in ((jcluster, jstream, jp), (tcluster, tstream, tp)):
        fleet = pipe.deploy_cluster(n_shards=2, t1_replicas=2, cache=cache)
        assert isinstance(fleet, pkg.TieredCluster)
        sim = spkg.TrafficSimulator(pipe.log, "rotate", seed=0, n_windows=5,
                                    queries_per_window=128)
        ctrl = _exact_ctrl(spkg.RetieringController)(
            pipe, engine=fleet, verify_swaps=True)
        runs.append((ctrl.run(sim), ctrl, fleet))
    (jrep, jctrl, jf), (trep, tctrl, tf) = runs

    def windows(rep):
        return [{k: v for k, v in w.to_dict().items() if k != "refit_seconds"}
                for w in rep.windows]
    assert windows(trep) == windows(jrep)
    assert trep.cumulative.to_dict() == jrep.cumulative.to_dict()
    assert tctrl.orders == jctrl.orders
    assert trep.n_refits > 0 and trep.n_parity_checks > 0
    assert trep.parity_all_ok()
    _same_fleet(tf, jf)
    assert tf.generation == trep.windows[-1].generation
    if cache:
        assert tf.cache.snapshot() == jf.cache.snapshot()
        assert trep.cumulative.cache_hits > 0


# -- load generator ------------------------------------------------------------------

def _plans(fleets):
    jf, tf = fleets
    tplan = tcluster.ClusterPlan.of_cluster(tf)
    assert dataclasses.astuple(tplan) == \
        dataclasses.astuple(jcluster.ClusterPlan.of_cluster(jf))
    return tplan


def test_loadgen_deterministic_and_equal_to_reference(tiny_data,
                                                      tiny_problem):
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=2)
    plan = _plans(fleets)
    elig = fleets[1].classify(tiny_data.log.queries[:256])
    a = tcluster.run_loadgen(plan, elig, n_queries=1500, seed=7)
    assert a == tcluster.run_loadgen(plan, elig, n_queries=1500, seed=7)
    assert a.to_dict() == jcluster.run_loadgen(
        jcluster.ClusterPlan.of_cluster(fleets[0]), elig, n_queries=1500,
        seed=7).to_dict()
    assert a.p50_ms <= a.p95_ms <= a.p99_ms <= a.max_ms
    assert 0.0 < a.tier1_fraction < 1.0
    assert tcluster.run_loadgen(plan, elig, n_queries=1500, seed=8) != a


def test_loadgen_strong_scaling_per_shard_words(tiny_data, tiny_problem):
    tierings = _tierings(tiny_data, tiny_problem)
    per_shard = []
    for n_shards in (1, 2, 4):
        fleets = _fleets(tiny_data, tierings, n_shards=n_shards,
                         t1_replicas=1)
        plan = _plans(fleets)
        elig = fleets[1].classify(tiny_data.log.queries[:256])
        rep = tcluster.run_loadgen(plan, elig, n_queries=1000, seed=0)
        per_shard.append(max(rep.per_shard_t2_words))
    assert per_shard[0] > per_shard[1] > per_shard[2]


def test_loadgen_rollout_outage_falls_back(tiny_data, tiny_problem):
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=1)
    plan = _plans(fleets)
    elig = np.ones(64, bool)
    kw = dict(n_queries=2000, seed=0, rate_qps=50000.0)
    quiet = tcluster.run_loadgen(plan, elig, **kw)
    rolled = tcluster.run_loadgen(plan, elig, rollout_at_s=0.01, swap_ms=5.0,
                                  **kw)
    assert quiet.t2_fallback_queries == 0 < rolled.t2_fallback_queries
    assert rolled.fleet_words > quiet.fleet_words
    assert rolled.to_dict() == jcluster.run_loadgen(
        plan, elig, rollout_at_s=0.01, swap_ms=5.0, **kw).to_dict()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_cluster_per_shard_budgets_exact_and_capped(dyadic_pipes, n_shards):
    jd, td = dyadic_pipes
    kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=n_shards)
    jp = japi.TieringPipeline.from_data(jd).solve("greedy", **kw)
    tp = tapi.TieringPipeline.from_data(td, device="cpu").solve("greedy", **kw)
    fleets = (jp.deploy_cluster(t1_replicas=2), tp.deploy_cluster(t1_replicas=2))
    tf = fleets[1]
    assert len(tf.shards) == n_shards
    queries = td.log.queries
    for s in range(0, len(queries), 128):
        _serve_both(fleets, queries[s:s + 128])
    _same_fleet(tf, fleets[0])
    caps = tp.result.extra["caps"]
    t1 = tp.tiering().tier1_docs
    buf = tf.router._buffers[tf.generation]
    for s, cap in zip(tf.shards, caps):
        local = int(t1[s.doc_lo:s.doc_lo + s.n_docs].sum())
        assert local <= cap
        assert buf.shard_words[s.index] == \
            (bitset.n_words(local) if local else 0)


def test_suggest_replicas_equals_reference(tiny_data, tiny_problem):
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=1, t2_replicas=1)
    plan = _plans(fleets)
    elig = fleets[1].classify(tiny_data.log.queries[:256])
    base = tcluster.run_loadgen(plan, elig, rate_qps=60000.0, n_queries=2000,
                                seed=0)
    slo = base.p95_ms / 4.0
    sug = tcluster.suggest_replicas(plan, 60000.0, slo, eligible=elig,
                                    n_queries=2000, seed=0)
    ref = jcluster.suggest_replicas(plan, 60000.0, slo, eligible=elig,
                                    n_queries=2000, seed=0)
    assert sug.meets_slo and sug.report.p95_ms <= slo
    assert sug.t1_replicas + sug.t2_replicas > 2
    assert (sug.t1_replicas, sug.t2_replicas, sug.meets_slo) == \
        (ref.t1_replicas, ref.t2_replicas, ref.meets_slo)
    assert sug.report.to_dict() == ref.report.to_dict()


def test_fit_service_model_equals_reference(rng):
    words = np.asarray([16, 64, 256, 1024, 4096], np.float64)
    us = 18.0 + words * 3.5 + rng.normal(0, 0.01, size=words.shape)
    fit = tcluster.fit_service_model(words, us)
    assert fit == jcluster.fit_service_model(words, us)
    assert fit["t_fixed_us"] == pytest.approx(18.0, abs=0.1)
    assert fit["r2"] > 0.9999


def test_deploy_cluster_facade(dyadic_pipes):
    _, td = dyadic_pipes
    pipe = tapi.TieringPipeline.from_data(td, device="cpu").solve(
        "greedy", budget_frac=0.5)
    fleet = pipe.deploy_cluster(n_shards=4, t1_replicas=2, t2_replicas=2)
    assert len(fleet.shards) == 4 and fleet.device == torch.device("cpu")
    _same_sets(fleet.serve(td.log.queries[:32]),
               fleet.serve_reference(td.log.queries[:32]))
    assert pipe.deploy_cluster(trace_capacity=None).trace.capacity is None


# -- ResultCache store mechanics ---------------------------------------------------------

def test_cache_validates_capacity_and_shards():
    with pytest.raises(ValueError, match="capacity"):
        tfrontend.ResultCache(capacity=0)
    with pytest.raises(ValueError, match="n_shards"):
        tfrontend.ResultCache(n_shards=0)
    assert tfrontend.ResultCache(capacity=3, n_shards=8).n_shards == 3


def test_cache_hit_miss_lru_ttl_and_epoch_equal_reference():
    now = [0.0]
    caches = [pkg.ResultCache(capacity=4, n_shards=2, ttl_s=1.0,
                              clock=lambda: now[0])
              for pkg in (jfrontend, tfrontend)]
    rng = np.random.default_rng(0)
    log = ([], [])
    for step in range(60):
        key = bytes([int(rng.integers(0, 7))])
        epoch = (int(step // 20), 0, True)
        now[0] = step * 0.1
        row = rng.integers(0, 2 ** 32, size=3, dtype=np.uint32)
        for c, out in zip(caches, log):
            got = c.lookup(epoch, key)
            out.append(None if got is None else (got[0], got[1].tobytes()))
            if got is None:
                c.insert(epoch, key, bool(step % 2), row)
        if step == 45:
            for c in caches:
                c.invalidate_below(3, 0)
    assert log[1] == log[0]
    assert caches[1].snapshot() == caches[0].snapshot()
    s = caches[1].stats
    assert s.hits and s.evictions and s.invalidations
    # a stored row is a private copy
    c = tfrontend.ResultCache(capacity=8)
    row = np.arange(3, dtype=np.uint32)
    c.insert((0, 0, True), b"k", True, row)
    row[0] = 99
    np.testing.assert_array_equal(c.lookup((0, 0, True), b"k")[1], [0, 1, 2])
    c.clear()
    assert len(c) == 0


def test_cache_ttl_expiry():
    now = [0.0]
    c = tfrontend.ResultCache(capacity=8, ttl_s=1.0, clock=lambda: now[0])
    c.insert((0, 0, True), b"k", False, np.zeros(1, np.uint32))
    now[0] = 0.9
    assert c.lookup((0, 0, True), b"k") is not None
    now[0] = 1.1
    assert c.lookup((0, 0, True), b"k") is None
    assert c.stats.expirations == 1


def test_cache_keys_land_in_the_reference_shards():
    keys = [bytes([i, i >> 3, 7]) for i in range(64)]
    t = tfrontend.ResultCache(capacity=64, n_shards=8)
    j = jfrontend.ResultCache(capacity=64, n_shards=8)
    for k in keys:
        t.insert((0, 0, True), k, True, np.zeros(1, np.uint32))
        j.insert((0, 0, True), k, True, np.zeros(1, np.uint32))
    assert [list(d) for d in t._shards] == [list(d) for d in j._shards]
    assert sum(1 for d in t._shards if len(d)) >= 4


def test_admission_policy_parse():
    for spec in ("0.5,2.0", "1.5", "-,3", ",4"):
        assert dataclasses.astuple(tfrontend.AdmissionPolicy.parse(spec)) == \
            dataclasses.astuple(jfrontend.AdmissionPolicy.parse(spec))
    assert tfrontend.AdmissionPolicy.parse("0.5,2.0").active
    assert not tfrontend.AdmissionPolicy().active
    with pytest.raises(ValueError, match="QUEUE_MS"):
        tfrontend.AdmissionPolicy.parse("1,2,3")


def test_zipf_keys_and_keys_of_equal_reference():
    for n, k, skew, seed in ((1000, 50, 1.1, 3), (4000, 50, 0.0, 0),
                             (500, 7, 2.0, 9)):
        np.testing.assert_array_equal(tfrontend.zipf_keys(n, k, skew, seed),
                                      jfrontend.zipf_keys(n, k, skew, seed))
    with pytest.raises(ValueError, match="n_keys"):
        tfrontend.zipf_keys(10, 0, 1.0)
    qs = [(1, 2), (2, 1), (1, 2, 2), (3,), (1, 2), ()]
    assert tfrontend.keys_of(qs).tolist() == jfrontend.keys_of(qs).tolist() \
        == [0, 0, 0, 1, 0, 2]


# -- router integration: hits bit-identical, keys the reference's bytes ------------

def test_router_cache_hits_bit_identical_and_stats(tiny_data, tiny_problem):
    tierings = _tierings(tiny_data, tiny_problem, solver="greedy")
    queries = tiny_data.log.queries[:64]
    _, plain = _fleets(tiny_data, tierings, n_shards=2, t1_replicas=2)
    fleets = _fleets(tiny_data, tierings, n_shards=2, t1_replicas=2,
                     cache=True)
    jf, cached = fleets
    assert plain.cache is None and cached.cache is not None
    _same_sets(cached.serve(queries), plain.serve(queries))
    jf.serve(queries)
    assert cached.cache.stats.hits == 0
    words = cached.stats.tier1_words + cached.stats.tier2_words
    _serve_both(fleets, queries)                 # warm: every query hits
    assert cached.cache.stats.hits == cached.stats.cache_hits == len(queries)
    assert cached.stats.tier1_words + cached.stats.tier2_words == words
    plain.serve(queries)
    assert cached.stats.tier1_fraction == plain.stats.tier1_fraction
    tr = cached.trace[-1]
    assert tr.n_cached == len(queries) and tr.n_tier1 == tr.n_tier2 == 0
    _same_fleet(cached, jf)
    # the cache holds the reference's keys and rows, byte for byte
    for dt, dj in zip(cached.cache._shards, jf.cache._shards):
        assert list(dt) == list(dj)
        for k in dt:
            (te, tb, tel, trow), (je, jb, jel, jrow) = dt[k], dj[k]
            assert (te, tel) == (je, jel) and trow.dtype == jrow.dtype
            np.testing.assert_array_equal(trow, jrow)


def test_router_cache_partial_hits(tiny_data, tiny_problem):
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem),
                     n_shards=2, t1_replicas=2, cache=True)
    queries = tiny_data.log.queries
    _serve_both(fleets, queries[:40])
    _serve_both(fleets, queries[20:80])          # half hits, half misses
    _same_fleet(fleets[1], fleets[0])
    assert fleets[1].trace[-1].n_cached > 0
    assert fleets[1].trace[-1].n_tier1 + fleets[1].trace[-1].n_tier2 > 0


def test_router_cache_coercion_forms(tiny_data, tiny_problem):
    tierings = _tierings(tiny_data, tiny_problem)
    assert _fleets(tiny_data, tierings, cache=None)[1].cache is None
    assert _fleets(tiny_data, tierings, cache=False)[1].cache is None
    assert _fleets(tiny_data, tierings, cache=64)[1].cache.capacity == 64
    rc = tfrontend.ResultCache(capacity=7)
    fleet = tcluster.TieredCluster(tiny_data.postings, tierings[1],
                                   tiny_data.n_docs, cache=rc, device="cpu")
    assert fleet.cache is rc


def test_router_cache_exact_across_rolling_tiering_swap(tiny_data,
                                                        tiny_problem):
    t_new = _tierings(tiny_data, tiny_problem, budget_frac=0.25,
                      solver="greedy")
    fleets = _fleets(tiny_data, _tierings(tiny_data, tiny_problem,
                                          solver="greedy"),
                     n_shards=2, t1_replicas=2, cache=True)
    jf, tf = fleets
    queries = tiny_data.log.queries[:48]
    _serve_both(fleets, queries)
    tf.swap_tiering(t_new[1])
    jf.swap_tiering(t_new[0])
    batches = 0
    while tf.router.rollout is not None and batches < 64:
        _serve_both(fleets, queries)
        batches += 1
    assert tf.router.rollout is None
    assert tf.cache.stats.invalidations > 0
    _serve_both(fleets, queries)
    assert tf.cache.stats.hits > 0
    _same_fleet(tf, jf)
    assert tf.cache.snapshot() == jf.cache.snapshot()


def test_frontend_counters_track_cache(tiny_data, tiny_problem):
    tierings = _tierings(tiny_data, tiny_problem)
    queries = tiny_data.log.queries[:32]
    prev_on = tobs.set_enabled(True)
    prev_ex = tobs.set_exporter(None)
    tobs.reset()
    try:
        _, fleet = _fleets(tiny_data, tierings, cache=True)
        assert tobs.REGISTRY.total("frontend_cache_hits_total") == 0
        fleet.serve(queries)
        fleet.serve(queries)
        s = fleet.cache.stats
        assert tobs.REGISTRY.total("frontend_cache_lookups_total") == s.lookups
        assert tobs.REGISTRY.total("frontend_cache_hits_total") == s.hits
        assert tobs.REGISTRY.total("frontend_cache_misses_total") == s.misses
        assert tobs.REGISTRY.total("cluster_queries_total") == 64
        serve = tobs.SPANS.of_name("serve")
        assert len(serve) == 2 and all(sp["fused"] is False
                                       for sp in serve)
    finally:
        tobs.reset()
        tobs.set_exporter(prev_ex)
        tobs.set_enabled(prev_on)


# -- loadgen: the reference's pinned values and front-end layers -------------------

_PLAN = tcluster.ClusterPlan(t1_words=((3, 3), (0, 0), (5, 5)),
                             t2_words=((8, 8), (7, 7), (9, 9)))
_ELIG = np.array([1, 0, 1, 1, 0], bool)


def _pin(rep, **want):
    for k, v in want.items():
        got = getattr(rep, k)
        if isinstance(v, float):
            assert got == pytest.approx(v, rel=1e-12, abs=0.0), (k, got)
        else:
            assert got == v, (k, got)


def _both(**kw):
    """The port's report, held equal to the reference's."""
    got = tcluster.run_loadgen(_PLAN, _ELIG, **kw)
    jkw = dict(kw)
    if isinstance(jkw.get("admission"), tfrontend.AdmissionPolicy):
        jkw["admission"] = jfrontend.AdmissionPolicy(
            *dataclasses.astuple(jkw["admission"]))
    want = jcluster.run_loadgen(jcluster.ClusterPlan(
        *dataclasses.astuple(_PLAN)), _ELIG, **jkw)
    assert got.to_dict() == want.to_dict()
    return got


def test_loadgen_defaults_off_pinned_base():
    rep = _both()
    _pin(rep, p50_ms=0.04000000000001225, p95_ms=0.056000000000000494,
         p99_ms=0.38399999999999546, mean_ms=0.053374920729458396,
         max_ms=0.461990155094405, fleet_words=57600,
         throughput_qps=19618.68981448589, max_t1_util=0.25210016411613734,
         max_t1_backlog_ms=0.09904343179559238)
    assert (rep.n_hedges, rep.n_hedge_wins, rep.n_hedge_cancels,
            rep.hedge_extra_words, rep.n_shed, rep.n_shed_to_t2,
            rep.n_cache_hits) == (0,) * 7


def test_loadgen_defaults_off_pinned_fast_and_rollout():
    _pin(_both(rate_qps=80000.0, n_queries=1500, seed=3),
         p50_ms=0.31151297096737673, p95_ms=1.230360015368779,
         p99_ms=1.3049804630053103, mean_ms=0.4536487489924385,
         fleet_words=21600, max_t1_util=0.9945387691335608)
    _pin(_both(rollout_at_s=0.01, swap_ms=2.0), mean_ms=0.053453239520822926,
         fleet_words=57600, max_t1_util=0.2534734724031512)
    _pin(_both(rollout_at_s=0.01, rollout_mode="stw", ingest_qps=500.0),
         p95_ms=52.36657698411578, p99_ms=58.59492847543175,
         mean_ms=13.45586276623517, n_ingest_events=102,
         ingest_words_total=13056, stw_delayed_queries=1189)


def test_hedging_and_admission_equal_reference():
    base = _both()
    hedged = _both(hedge_ms=0.1)
    assert 0 < hedged.n_hedge_wins <= hedged.n_hedges == \
        hedged.n_hedge_cancels
    assert hedged.p99_ms < base.p99_ms
    assert hedged.fleet_words == base.fleet_words
    solo = _PLAN.resized(t1_replicas=1, t2_replicas=1)
    assert tcluster.run_loadgen(solo, _ELIG, hedge_ms=0.1).n_hedges == 0
    policy = tfrontend.AdmissionPolicy(queue_bound_ms=0.3, deadline_ms=1.0)
    kw = dict(rate_qps=200000.0, n_queries=3000, seed=0)
    shed = _both(admission=policy, **kw)
    assert shed.n_shed > 0 and shed.n_shed_to_t2 > 0
    assert shed.p99_ms < _both(**kw).p99_ms
    assert _both(admission=tfrontend.AdmissionPolicy()).to_dict() == \
        base.to_dict()


def test_loadgen_cache_model_and_roundtrip():
    keys = tfrontend.zipf_keys(4000, 100, 1.1, seed=0)
    rep = _both(cache_keys=keys, hedge_ms=0.1)
    assert rep.cache_hit_rate > 0.5
    assert f"cache_hit={rep.cache_hit_rate:.3f}" in rep.line()
    with pytest.raises(ValueError, match="cache_keys"):
        tcluster.run_loadgen(_PLAN, _ELIG, cache_keys=np.empty(0, np.int64))
    with pytest.raises(ValueError, match="cache_capacity"):
        tcluster.run_loadgen(_PLAN, _ELIG, cache_keys=keys, cache_capacity=0)
    d = rep.to_dict()
    assert tcluster.LoadgenReport.from_dict(d).to_dict() == d
    prev_on, prev_ex = tobs.set_enabled(True), tobs.set_exporter(None)
    tobs.reset()
    try:
        again = tcluster.run_loadgen(_PLAN, _ELIG, hedge_ms=0.1,
                                     cache_keys=keys)
        assert tobs.REGISTRY.total("loadgen_hedges_total") == again.n_hedges
    finally:
        tobs.reset()
        tobs.set_exporter(prev_ex)
        tobs.set_enabled(prev_on)
    assert jobs.enabled() in (True, False)


# -- the launcher -----------------------------------------------------------------------

def test_cluster_launcher_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "cluster", "--scale", "tiny", "--shards", "4", "--replicas", "2",
        "--budget-split", "traffic", "--cache", "--verify", "--windows", "4",
        "--requests", "1000", "--device", "cpu", "--obs-dir", ""])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out and "[cluster] verified:" in out
    assert "per-shard caps respected" in out and "cached answers" in out


def test_cluster_launcher_refuses_mesh():
    """`--mesh` on a device type with no visible device refuses before any
    work, instead of serving on another device."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.cluster",
                          "--mesh", "--device", "cuda", "--obs-dir", ""],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no visible cuda device for a shard mesh" in out.stderr
    assert "offline solve" not in out.stdout
