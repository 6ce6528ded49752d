"""The port's streaming re-tiering against the reference's.

The same seeded inputs go through `repro.stream` and `repro_torch.stream`
(on the CPU) and the results must be equal: the simulator's windows, the
accumulator's weights, the detector's signals, `prune_state` /
`prune_partitions`' kept and dropped sets and rebuilt states, refit orders,
every `WindowReport` but its wall-clock `refit_seconds`, and the
cumulative `ServeStats`.

Weights are exact so that every f32 sum is exact in any order (ROADMAP
fault 1): both packages mine the log with its weights as counts over a
power-of-two denominator, and the refit weights, which blend the
accumulator's decayed counts with the prior and so are not dyadic, are
rounded to multiples of 2^-22 by a test-only subclass of each package's
`RetieringController` (`_refit`) before any solve or prune sees them.
Other hand-made weights here are rounded the same way.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import stream as jstream
from repro.serve.engine import ServeStats as JStats
from repro_torch import api as tapi
from repro_torch import stream as tstream
from repro_torch.core import bitset
from repro_torch.launch import stream as tlaunch
from repro_torch.serve.engine import ServeStats as TStats

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


def recording(cls):
    """`cls` with refit weights rounded to 2^-22 and each refit's order kept."""
    class Exact(cls):
        def _refit(self, solve_w, raw_w, report):
            super()._refit(exact(solve_w), raw_w, report)
            self.orders = getattr(self, "orders", []) + [
                list(self.pipe.result.order)]
    return Exact


JCtrl = recording(jstream.RetieringController)
TCtrl = recording(tstream.RetieringController)


@pytest.fixture(scope="module")
def datas():
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    return jp.mine(min_support=1e-3).data, tp.mine(min_support=1e-3).data


def fresh(datas, **solve):
    """A pipeline of each package on the mined data, greedy-solved."""
    kw = dict(budget_frac=0.5, **solve)
    jd, td = datas
    jp = japi.TieringPipeline.from_data(jd).solve("greedy", **kw)
    tp = tapi.TieringPipeline.from_data(td, device="cpu").solve("greedy", **kw)
    assert tp.result.order == jp.result.order
    return jp, tp


def window_dict(w):
    d = w.to_dict()
    d.pop("refit_seconds")
    return d


def assert_same_run(jrep, trep, jctrl=None, tctrl=None):
    assert [window_dict(w) for w in trep.windows] == \
        [window_dict(w) for w in jrep.windows]
    assert trep.cumulative.to_dict() == jrep.cumulative.to_dict()
    assert trep.summary() == jrep.summary()
    if jctrl is not None:
        assert getattr(tctrl, "orders", []) == getattr(jctrl, "orders", [])


def run_both(jp, tp, scenario, n_windows, qpw, *, seed=0, engines=(None, None),
             **kw):
    out = []
    for pkg, ctrl_cls, pipe, engine in ((jstream, JCtrl, jp, engines[0]),
                                        (tstream, TCtrl, tp, engines[1])):
        sim = pkg.TrafficSimulator(pipe.log, scenario, seed=seed,
                                   n_windows=n_windows, queries_per_window=qpw)
        ctrl = ctrl_cls(pipe, engine=engine, **kw)
        out.append((ctrl.run(sim), ctrl))
    (jrep, jctrl), (trep, tctrl) = out
    assert_same_run(jrep, trep, jctrl, tctrl)
    return jrep, trep, tctrl


# -- SCSKProblem.with_weights (the refit's reweighting) ------------------------

def test_with_weights_equals_reference_and_shares_bitsets(datas):
    jp, tp = fresh(datas)
    rng = np.random.default_rng(7)
    w = exact(np.asarray(tp.log.train_weights) * rng.uniform(0.1, 4.0,
                                                             tp.log.n_queries))
    jr, tr = jp.problem.with_weights(w), tp.problem.with_weights(w)
    np.testing.assert_array_equal(tr.query_weights.numpy(),
                                  np.asarray(jr.query_weights))
    assert tr.clause_query_bits is tp.problem.clause_query_bits
    assert tr.clause_doc_bits is tp.problem.clause_doc_bits
    assert tr.test_weights is tp.problem.test_weights
    with pytest.raises(ValueError, match="shape"):
        tp.problem.with_weights(np.ones(tp.problem.n_queries + 3))


# -- traffic simulator ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scenario", jstream.list_scenarios())
def test_simulator_windows_equal_reference(datas, scenario, seed):
    jd, td = datas
    assert tstream.list_scenarios() == jstream.list_scenarios()
    kw = dict(seed=seed, n_windows=6, queries_per_window=64)
    jw = list(jstream.TrafficSimulator(jd.log, scenario, **kw).windows())
    tw = list(tstream.TrafficSimulator(td.log, scenario, **kw).windows())
    assert len(tw) == len(jw) == 6
    for a, b in zip(tw, jw):
        assert a.index == b.index
        np.testing.assert_array_equal(a.query_ids, b.query_ids)
        np.testing.assert_array_equal(a.probs, b.probs)
        assert a.probs.sum() == pytest.approx(1.0)
    train = tstream.TrafficSimulator(td.log, scenario, base="train", **kw)
    ref = jstream.TrafficSimulator(jd.log, scenario, base="train", **kw)
    np.testing.assert_array_equal(train.window_probs(4), ref.window_probs(4))


def test_simulator_rejects_unknown_scenario_and_base(datas):
    _, td = datas
    with pytest.raises(KeyError, match="unknown scenario"):
        tstream.TrafficSimulator(td.log, "nope")
    with pytest.raises(ValueError, match="base"):
        tstream.TrafficSimulator(td.log, "rotate", base="other")


# -- log accumulator -------------------------------------------------------------

@pytest.mark.parametrize("halflife,prior_strength", [(1.0, 0.0), (2.0, 32.0),
                                                     (0.5, 4.0)])
def test_accumulator_equals_reference(halflife, prior_strength):
    rng = np.random.default_rng(int(halflife * 10 + prior_strength))
    prior = rng.dirichlet(np.ones(50))
    accs = [pkg.LogAccumulator(50, halflife=halflife, prior=prior,
                               prior_strength=prior_strength)
            for pkg in (jstream, tstream)]
    for _ in range(5):
        ids = rng.integers(0, 50, size=40)
        for acc in accs:
            acc.observe(ids)
        np.testing.assert_array_equal(accs[1].weights(), accs[0].weights())
        assert accs[1].total() == accs[0].total()
    assert accs[1].n_windows == 5


def test_accumulator_tracks_decays_and_validates():
    acc = tstream.LogAccumulator(4, halflife=1.0)
    acc.observe(np.array([0, 0, 0, 1]))
    assert acc.weights()[0] == pytest.approx(0.75)
    for _ in range(5):
        acc.observe(np.array([2, 2, 2, 2]))
    assert acc.weights()[2] > 0.9 and acc.weights()[0] < 0.05
    assert tstream.LogAccumulator(3).weights() == pytest.approx([1 / 3] * 3)
    with pytest.raises(ValueError, match="halflife"):
        tstream.LogAccumulator(3, halflife=0)
    with pytest.raises(ValueError, match="prior"):
        tstream.LogAccumulator(3, prior=np.ones(4), prior_strength=1.0)


# -- drift detector ---------------------------------------------------------------

def _signals(pkg, stats_cls, n_samples):
    det = pkg.DriftDetector(tv_threshold=0.1, coverage_drop=0.05,
                            min_windows_between=2, warmup_windows=1)
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(200))
    det.rebase(p, 0.7)
    out = []
    for i in range(8):
        q = 0.5 * p + 0.5 * rng.dirichlet(np.ones(200)) if i % 3 else p
        stats = stats_cls(n_queries=100, n_tier1=70 - 4 * i)
        out.append(det.update(stats, q, n_samples=n_samples))
        if out[-1].triggered:
            det.rebase(q, 0.6)
    return out


@pytest.mark.parametrize("n_samples", [None, 400.0, 40000.0])
def test_detector_signals_equal_reference(n_samples):
    got = _signals(tstream, TStats, n_samples)
    want = _signals(jstream, JStats, n_samples)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert any(s.triggered for s in got)
    assert tstream.tv_distance([0.5, 0.5, 0.0], [0.0, 0.5, 0.5]) == \
        jstream.tv_distance([0.5, 0.5, 0.0], [0.0, 0.5, 0.5])


def test_detector_hysteresis_and_noise_floor():
    det = tstream.DriftDetector(tv_threshold=0.1, coverage_drop=0.5,
                                min_windows_between=2, warmup_windows=1)
    stats = TStats(n_queries=10, n_tier1=7)
    p, q = np.array([0.5, 0.5, 0.0]), np.array([0.0, 0.5, 0.5])
    det.rebase(p, 0.7)
    s1 = det.update(stats, q)
    assert s1.tv_distance == pytest.approx(0.5) and not s1.triggered
    s2 = det.update(stats, q)
    assert s2.triggered and "tv" in s2.reasons[0]
    det.rebase(q, 0.7)
    assert not det.update(stats, q).triggered
    # a static workload's sampling jitter stays under the noise floor
    det = tstream.DriftDetector(tv_threshold=0.05, coverage_drop=1.0,
                                warmup_windows=0, min_windows_between=0)
    rng = np.random.default_rng(0)
    p = rng.dirichlet(np.ones(500))
    det.rebase(p, 0.7)
    for _ in range(5):
        emp = np.bincount(rng.choice(500, size=400, p=p), minlength=500) / 400
        sig = det.update(stats, emp, n_samples=400)
        assert sig.tv_noise_floor > 0 and not sig.triggered
    assert det.update(stats, 0.5 * p + 0.5 * np.eye(500)[0],
                      n_samples=400).triggered


# -- prune_state / prune_partitions -------------------------------------------------

def _drifted(log, seed=7):
    rng = np.random.default_rng(seed)
    w = np.asarray(log.train_weights) * rng.uniform(0.1, 4.0, log.n_queries)
    return exact(w / w.sum())


def _same_state(t, j):
    np.testing.assert_array_equal(bitset.to_numpy(t.covered_q),
                                  np.asarray(j.covered_q))
    np.testing.assert_array_equal(bitset.to_numpy(t.covered_d),
                                  np.asarray(j.covered_d))
    np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
    assert float(t.g_used) == float(j.g_used) and t.step == int(j.step)


@pytest.mark.parametrize("via", ["weights", "problem"])
@pytest.mark.parametrize("floor", [0.0, 2e-3, 5e-3, 2.0])
def test_prune_state_equals_reference(datas, floor, via):
    jp, tp = fresh(datas)
    w = _drifted(tp.log)
    if via == "weights":
        jout = jstream.prune_state(jp.problem, jp.result.state, weights=w,
                                   min_unique_mass=floor)
        tout = tstream.prune_state(tp.problem, tp.result.state, weights=w,
                                   min_unique_mass=floor)
    else:
        jout = jstream.prune_state(jp.problem.with_weights(w),
                                   jp.result.state, min_unique_mass=floor)
        tout = tstream.prune_state(tp.problem.with_weights(w),
                                   tp.result.state, min_unique_mass=floor)
    (js, jk, jdrop), (ts, tk, tdrop) = jout, tout
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tdrop, jdrop)
    assert tk.dtype == tdrop.dtype == np.int64
    _same_state(ts, js)
    if floor == 0.0:
        assert ts is tp.result.state and len(tdrop) == 0
    if floor == 2.0:
        assert len(tk) == 0 and float(ts.g_used) == 0.0
    if 0 < floor < 1:
        assert len(tdrop) > 0 and len(tk) > 0


def test_prune_state_rejects_bad_weights_and_stale_width(datas):
    _, tp = fresh(datas)
    st = tp.result.state
    with pytest.raises(ValueError, match="shape"):
        tstream.prune_state(tp.problem, st, weights=np.ones(3),
                            min_unique_mass=1e-3)
    stale = st.replace(covered_d=st.covered_d[:-1])
    with pytest.raises(ValueError, match="stale SolverState"):
        tstream.prune_state(tp.problem, stale, min_unique_mass=1e-3)
    with pytest.raises(ValueError, match="selection slots"):
        tstream.check_state_width(tp.problem,
                                  st.replace(selected=st.selected[:-1]))
    rebuilt = tstream.rebuild_state(tp.problem, tp.result.order)
    for f in ("covered_q", "covered_d", "selected", "g_used"):
        assert torch.equal(getattr(rebuilt, f), getattr(st, f))


@pytest.mark.parametrize("parts,scope_frac", [([1], 0.5), ([0], 0.5),
                                              ([0, 1], 0.0), ([1], 0.9),
                                              ([], 0.5)])
def test_prune_partitions_equals_reference(datas, parts, scope_frac):
    from repro.core import partition_bounds
    jp, tp = fresh(datas)
    bounds = partition_bounds(tp.problem.n_docs, 2)
    js, jk, jdrop = jstream.prune_partitions(jp.problem, jp.result.state,
                                             bounds, parts,
                                             scope_frac=scope_frac)
    ts, tk, tdrop = tstream.prune_partitions(tp.problem, tp.result.state,
                                             bounds, parts,
                                             scope_frac=scope_frac)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tdrop, jdrop)
    _same_state(ts, js)
    assert set(tk) | set(tdrop) == set(tp.result.order)


# -- refit: warm against cold ----------------------------------------------------------

def test_refit_warm_and_cold_equal_reference(datas):
    _, td = datas
    drifted = exact(tstream.TrafficSimulator(td.log, "rotate", seed=0,
                                             n_windows=12).window_probs(3))
    jc, tc = fresh(datas)
    jc.refit(drifted, state=None)
    tc.refit(drifted, state=None)
    assert tc.result.order == jc.result.order
    jw, tw = fresh(datas)
    _, jk, _ = jstream.prune_state(jw.problem, jw.result.state,
                                   weights=drifted, min_unique_mass=2e-3)
    ts, tk, _ = tstream.prune_state(tw.problem, tw.result.state,
                                    weights=drifted, min_unique_mass=2e-3)
    np.testing.assert_array_equal(tk, jk)
    jw.refit(drifted, state=jstream.rebuild_state(jw.problem, jk))
    tw.refit(drifted, state=ts)
    assert tw.result.order == jw.result.order
    assert 0 < len(tw.result.order) < len(tc.result.order)
    assert np.all(tw.result.selected[tk])      # the warm prefix survives
    assert tw.verify()


# -- the control loop --------------------------------------------------------------------

def test_rotation_retiering_beats_static_with_parity(datas):
    kw = dict(scenario="rotate", n_windows=12, qpw=512)
    jp, tp = fresh(datas)
    _, static, _ = run_both(jp, tp, enable_refit=False, **kw)
    jp, tp = fresh(datas)
    _, retiered, ctrl = run_both(jp, tp, verify_swaps=True, **kw)
    assert static.n_refits == 0
    assert retiered.n_refits > 0 and retiered.n_warm > 0
    assert retiered.mean_coverage > static.mean_coverage
    assert retiered.n_parity_checks > 0 and retiered.parity_all_ok()
    assert retiered.cumulative.n_queries == static.cumulative.n_queries
    assert len(ctrl.orders) == retiered.n_refits


@pytest.mark.parametrize("scenario", ["burst", "churn", "seasonal"])
def test_cumulative_equals_window_sum(datas, scenario):
    jp, tp = fresh(datas)
    _, rep, _ = run_both(jp, tp, scenario, 4, 128)
    assert rep.cumulative.n_queries == 4 * 128
    for f in ("n_tier1", "tier1_words", "tier2_words"):
        assert getattr(rep.cumulative, f) == \
            sum(getattr(w.stats, f) for w in rep.windows)


def test_cold_controller_equals_reference(datas):
    jp, tp = fresh(datas)
    _, rep, _ = run_both(jp, tp, "seasonal", 6, 256, warm=False,
                         serve_batch=100)
    assert rep.n_refits > 0 and rep.n_warm == 0


def test_scoped_refit_with_traffic_split_equals_reference(datas):
    jp, tp = fresh(datas, budget_split="traffic", n_shards=2)
    total = tp.result.extra["caps"].sum()
    _, rep, _ = run_both(jp, tp, "rotate", 6, 256, verify_swaps=True)
    assert rep.n_refits > 0 and rep.parity_all_ok()
    assert all(len(w.shard_tv) == 2 for w in rep.windows)
    assert [w for w in rep.windows if w.refit and w.scope]
    for key in ("caps", "g_part"):
        np.testing.assert_array_equal(tp.result.extra[key],
                                      jp.result.extra[key])
    caps = tp.result.extra["caps"]
    assert caps.sum() == total
    assert np.all(tp.result.extra["g_part"] <= caps + 1e-6)


def test_single_shard_drift_scopes_one_shard(datas):
    from repro.core import partition_bounds
    jd, td = datas
    bounds = partition_bounds(td.n_docs, 2)
    qdb = td.query_doc_bits
    mass0 = bitset.np_popcount(qdb[:, :bounds[1]])
    mass1 = bitset.np_popcount(qdb[:, bounds[1]:])
    only1 = (mass1 > 0) & (mass0 == 0)
    assert only1.sum() >= 8
    jp, tp = fresh(datas, budget_split="traffic", n_shards=2)
    jc = JCtrl(jp, shard_tv_threshold=0.2)
    tc = TCtrl(tp, shard_tv_threshold=0.2)
    ids = np.nonzero(only1)[0]
    probs = np.where(only1, 1.0, 0.0) / only1.sum()
    scope = ()
    for i in range(4):
        win = tstream.TrafficWindow(index=i, query_ids=np.resize(ids, 256),
                                    probs=probs)
        jwin = jstream.TrafficWindow(index=i, query_ids=win.query_ids,
                                     probs=probs)
        trep, jrep = tc.step(win), jc.step(jwin)
        assert window_dict(trep) == window_dict(jrep)
        if trep.refit and trep.scope:
            scope = trep.scope
            break
    assert 1 in scope
    assert tc.orders == jc.orders


def test_controller_eligibility_equals_classify_queries(datas):
    """The controller's ψ over the whole query universe (`clause_match` on
    tokens packed in chunks) == the host reference `classify_queries`, and
    == the reference controller's."""
    jp, tp = fresh(datas)
    tc = tstream.RetieringController(tp)
    jc = jstream.RetieringController(jp)
    tiering = tp.tiering()
    want = tiering.classify_queries(tp.log.query_bits)
    got = tc._eligible(tiering)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jc._eligible(jp.tiering()))
    assert tc._eligible(tiering) is got                # cached per tiering
    assert 0 < got.sum() < len(got)
    w = exact(tp.log.test_weights)
    assert tc.coverage_of(tiering, w) == jc.coverage_of(jp.tiering(), w)
    # the chunking: one query word budget per chunk still covers everyone
    import repro_torch.stream.controller as tcm
    old = tcm._ELIG_CHUNK_WORDS
    try:
        tcm._ELIG_CHUNK_WORDS = 7 * bitset.n_words(tiering.vocab_size)
        tc._elig_cache = []
        np.testing.assert_array_equal(tc._eligible(tiering), want)
    finally:
        tcm._ELIG_CHUNK_WORDS = old


# -- ServeStats' window methods ---------------------------------------------------------

def test_serve_stats_methods_equal_reference():
    kw = dict(n_queries=10, n_tier1=7, tier1_words=40, tier2_words=90,
              full_words_per_query=30, cache_hits=2)
    for op in ("snapshot", "reset", "merge", "from_dict"):
        t, j = TStats(**kw), JStats(**kw)
        if op == "snapshot":
            ts, js = t.snapshot(), j.snapshot()
            t.n_queries += 1
            assert ts.to_dict() == js.to_dict() and ts.n_queries == 10
        elif op == "reset":
            t.reset()
            j.reset()
            assert t.to_dict() == j.to_dict()
            assert t.full_words_per_query == 30 and t.n_queries == 0
        elif op == "merge":
            other = dict(kw, n_queries=5, n_tier1=1)
            assert t.merge(TStats(**other)) is t
            j.merge(JStats(**other))
            assert t.to_dict() == j.to_dict()
            empty_t, empty_j = TStats(), JStats()
            empty_t.merge(t)
            empty_j.merge(j)
            assert empty_t.to_dict() == empty_j.to_dict()
            with pytest.raises(ValueError) as te:
                t.merge(TStats(full_words_per_query=31))
            with pytest.raises(ValueError) as je:
                j.merge(JStats(full_words_per_query=31))
            assert str(te.value) == str(je.value)
        else:
            d = j.to_dict()
            assert TStats.from_dict(d).to_dict() == \
                JStats.from_dict(d).to_dict()
            assert TStats.from_dict(t.to_dict()) == t


def test_reports_roundtrip(datas):
    jp, tp = fresh(datas)
    _, rep, _ = run_both(jp, tp, "rotate", 4, 128)
    back = tstream.StreamReport.from_dict(rep.to_dict())
    assert back.to_dict() == rep.to_dict()
    assert [w.line() for w in back.windows] == [w.line() for w in rep.windows]


# -- the launcher ----------------------------------------------------------------------------

def test_stream_launcher_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "stream", "--scale", "tiny", "--windows", "6", "--verify",
        "--device", "cpu", "--obs-dir", ""])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out and "parity verified after" in out
    assert "mean windowed tier-1 coverage" in out


def test_stream_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["stream", "--scale", "tiny",
                                     "--obs-dir", ""])
    with pytest.raises((RuntimeError, AssertionError)):
        tlaunch.main()
