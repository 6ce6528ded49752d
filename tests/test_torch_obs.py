"""The port's telemetry plane (`repro_torch.obs`) against the reference's.

Each scenario runs the same sequence of calls against both packages' plane
and must give the same record: instruments and their dumps, span and event
dicts, JSONL lines, rendered lines, SLO evaluations and transitions, with
only wall-clock fields (`ts`, `t_s`, `t0_s`, `wall_ms`, `sync_ms`,
`seconds`) left out. Then the instrumented call sites: the solver trace's
counters and `solve_done` event and the serve engine's spans and counters
after the same solve and serve, the kernel ops' word and byte counts for
the same calls (the `path` label reads "cpu" where the reference's reads
"xla"), and bit-identical solves and serves with the plane off. The
reference's wall-clock overhead bound is not copied: a ratio of two
timings says nothing certain on a shared machine.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.obs as jlaunch
import repro.obs as jobs
import repro.obs.slo as jslo
import repro_torch.launch.obs as tlaunch
import repro_torch.obs as tobs
import repro_torch.obs.slo as tslo

ROOT = Path(__file__).resolve().parents[1]
PLANES = (jobs, tobs)
TIMING = ("ts", "t_s", "t0_s", "wall_ms", "sync_ms", "seconds")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its CPU solves are long chains
    of small tensor ops, where more threads cost more CPU than they save
    and take cores from the test run's other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_planes():
    """Both planes enabled, empty, exporter-free and rule-free; restored
    afterwards."""
    saved = []
    for o in PLANES:
        saved.append((o.set_enabled(True), o.set_exporter(None)))
        o.SLO.set_rules([])
        o.reset()
    yield
    for o, (on, ex) in zip(PLANES, saved):
        o.reset()
        o.SLO.set_rules([])
        o.set_exporter(ex)
        o.set_enabled(on)


def strip(obj):
    """Drop wall-clock fields so two runs compare."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in TIMING}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


def err(fn):
    """The exception a call raises, as (type name, message)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


def both(scenario):
    """Run `scenario(obs)` on the reference's plane and on the port's; the
    records must be equal. Returns the port's."""
    want, got = (strip(scenario(o)) for o in PLANES)
    assert got == want
    return got


# -- ring, registry, instruments ----------------------------------------------

def test_ring_bounds_unbounded_and_invalid_capacity():
    def run(o):
        r = o.Ring(3)
        for i in range(7):
            r.append(i)
        u = o.Ring(None)
        u.extend(range(100))
        return [r.to_list(), len(r), r.n_seen, r.n_dropped, r[0], r[-1],
                r[1:], bool(r), list(r), repr(r), len(u), u.n_dropped,
                repr(u), err(lambda: o.Ring(0))]
    got = both(run)
    assert got[0] == [4, 5, 6] and got[3] == 4


def test_counter_labels_total_and_monotonicity():
    def run(o):
        c = o.counter("t_words", labels=("tier", "shard"))
        c.inc(5, tier="t1", shard=0)
        c.inc(3, tier="t2", shard=1)
        c.inc(2, tier="t1", shard=0)
        return [c.value(tier="t1", shard=0), c.total(),
                o.REGISTRY.total("t_words"),
                err(lambda: c.inc(-1, tier="t1", shard=0)),
                err(lambda: c.inc(1, tier="t1")), c.to_dict(),
                o.REGISTRY.collect()]
    got = both(run)
    assert got[0] == 7 and got[1] == 10


def test_registry_idempotent_and_conflicts():
    def run(o):
        a = o.counter("t_same", labels=("x",))
        o.histogram("t_h", buckets=(1.0, 2.0))
        return [o.counter("t_same", labels=("x",)) is a,
                err(lambda: o.gauge("t_same")),
                err(lambda: o.counter("t_same", labels=("y",))),
                err(lambda: o.histogram("t_h", buckets=(1.0, 3.0))),
                err(lambda: o.histogram("t_bad", buckets=(2.0, 1.0))),
                "t_same" in o.REGISTRY, o.REGISTRY.get("t_nope")]
    got = both(run)
    assert got[0] is True and got[1][0] == "ValueError"


def test_histogram_observe_percentile_snapshot():
    def run(o):
        h = o.histogram("t_lat", buckets=(1.0, 10.0, 100.0))
        h.observe(0.5)
        h.observe_many([5.0, 5.0, 50.0, 500.0])
        h.observe_many([])
        e = o.histogram("t_empty")
        return [h.snapshot(), h.percentile(50), h.percentile(100),
                h.percentile(0), math.isnan(e.percentile(50)),
                e.snapshot(), h.to_dict()]
    got = both(run)
    assert got[0]["counts"] == [1, 2, 1, 1] and got[2] == 500.0


def test_registry_reset_keeps_instrument_identity():
    def run(o):
        c = o.counter("t_keep")
        g = o.gauge("t_keep_g", labels=("k",))
        c.inc(4)
        g.set(2.5, k="a")
        o.reset()
        out = [c.value(), o.counter("t_keep") is c, g.value(k="a"),
               o.REGISTRY.collect()]
        c.inc(1)
        return out + [o.REGISTRY.total("t_keep")]
    got = both(run)
    assert got[0] == 0 and got[-1] == 1


# -- spans & events -------------------------------------------------------------

def test_span_nesting_parent_depth_and_dict():
    def run(o):
        with o.span("outer", n=2) as a:
            with o.span("inner") as b:
                b.set(hits=3)
            rel = (b.parent == a.id, b.depth == a.depth + 1)
        recs = o.SPANS.to_list()
        return [rel, recs, o.SPANS.of_name("inner"), o.SPANS.children(a.id),
                sorted(recs[0]), o.SPANS.seq, o.SPANS.since(1),
                list(o.SPANS.walk())]
    got = both(run)
    assert got[0] == [True, True] and [r["name"] for r in got[1]] == \
        ["inner", "outer"]


def test_span_sync_passes_host_values_and_waits_for_tensors():
    def run(o):
        with o.span("s") as sp:
            a = sp.sync([1, 2, 3])
            b = sp.sync(np.arange(3)).tolist()
        return [a, b, o.SPANS.to_list()]
    both(run)
    t = torch.arange(4)
    with tobs.span("t") as sp:             # CPU tensors: nothing to wait for
        assert sp.sync(t) is t and sp.sync((t, {"x": t}))[0] is t
    assert tobs.spans.block_until_ready("v") == "v"


def test_event_log_and_cursors():
    def run(o):
        o.event("alpha", x=1)
        seq = o.EVENTS.seq
        o.event("beta", y=2)
        return [o.EVENTS.since(seq), o.EVENTS.of_kind("alpha"),
                o.EVENTS.to_list(), len(o.EVENTS), o.EVENTS.since(0),
                o.EVENTS.since(5)]
    got = both(run)
    assert [e["kind"] for e in got[0]] == ["beta"]


def test_disabled_plane_is_noop():
    def run(o):
        o.set_enabled(False)
        sp = o.span("anything", n=1)
        with sp as s:
            s.set(x=1)
            v = s.sync("v")
        c = o.counter("t_off")
        c.inc(5)
        g = o.gauge("t_off_g")
        g.set(3.0)
        h = o.histogram("t_off_h")
        h.observe(1.0)
        d = o.Histogram("t_detached", always=True, buckets=(1.0, 2.0))
        d.observe(1.5)
        return [sp is o.NULL_SPAN, v, o.event("nothing"), c.total(),
                g.value(), h.snapshot()["count"], len(o.SPANS.ring),
                len(o.EVENTS), d.snapshot()["count"], o.enabled(),
                o.disabled(), o.export_window(0), o.SLO.evaluate(0)]
    got = both(run)
    assert got[0] is True and got[3] == 0 and got[8] == 1


def test_switch_round_trip_and_env_gate():
    def run(o):
        return [o.disable(), o.enabled(), o.enable(), o.set_enabled(False),
                o.set_enabled(True)]
    both(run)
    code = ("import repro_torch.obs as o; import sys; "
            "print(o.enabled(), 'torch' in sys.modules)")
    for value, want in (("0", "False"), ("off", "False"), ("1", "True")):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_OBS=value)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.split() == [want, "False"], out.stderr


# -- render & export ----------------------------------------------------------------

def test_render_line_and_fmt_value():
    def run(o):
        return [o.render_line("tag", [("@head", "3 windows"), ("cov", 0.5),
                                      ("ok", True), ("bad", False),
                                      ("skip", None), ("xs", [1, 2])]),
                o.render_line("", {"a": 1, "b": (0.25, True)}, sep=" | "),
                [o.fmt_value(v) for v in (1, 2.0, "s", None, [1.5, False])]]
    got = both(run)
    assert got[0] == "tag  3 windows  cov=0.500  ok=ok  bad=FAIL  xs=[1,2]"


def test_jsonl_exporter_round_trip(tmp_path):
    def run(o):
        d = tmp_path / o.__name__
        ex = o.JsonlExporter(d, run="r1")
        ex.export({"window": 0, "v": np.int64(3), "a": np.arange(2),
                   "f": np.float32(0.5)})
        ex.export({"window": 1, "v": 4, "a": []})
        first = ex.path.read_text()
        snaps = o.read_jsonl(ex.path)
        o.JsonlExporter(d, run="r1").export({"window": 9})
        return [first, snaps, o.load_dir(d), ex.n_written,
                o.read_jsonl(ex.path), o.load_dir(tmp_path / "none")]
    got = both(run)
    assert [s["window"] for s in got[1]] == [0, 1] and got[1][0]["a"] == [0, 1]


def test_export_window_cursors_and_gating(tmp_path):
    def run(o):
        out = [o.export_window(0)]                 # no exporter: no-op
        o.set_exporter(o.JsonlExporter(tmp_path / o.__name__, run="w"))
        with o.span("s1"):
            pass
        o.event("e1")
        out.append(o.export_window(0))
        with o.span("s2"):
            pass
        out.append(o.export_window(1, extra_key="x"))
        o.set_enabled(False)
        out.append(o.export_window(2))             # disabled: no write
        o.set_enabled(True)
        out.append(o.read_jsonl(o.get_exporter().path))
        return out
    got = both(run)
    assert got[0] is None and got[3] is None and len(got[4]) == 2
    assert [s["name"] for s in got[2]["spans"]] == ["s2"]


def test_snapshot_rings_and_empty_window(tmp_path):
    def run(o):
        o.set_exporter(o.JsonlExporter(tmp_path / o.__name__, run="rings"))
        empty = o.export_window(0)
        n = o.DEFAULT_EVENT_CAPACITY + 50
        for i in range(n):
            o.event("flood", i=i)
        dropped = o.export_window(1)
        lines = [json.loads(ln) for ln in
                 o.get_exporter().path.read_text().splitlines()]
        return [empty, dropped["rings"], len(dropped["events"]), lines[0],
                [sorted(ln) for ln in lines], o.dashboard()]
    got = both(run)
    assert got[1]["events"] == {"n_seen": tobs.DEFAULT_EVENT_CAPACITY + 50,
                                "n_dropped": 50}


# -- launch.obs ---------------------------------------------------------------------

def _run_with_rings(seen, dropped):
    return {"r": [{"window": 0, "ts": 0.0, "events": [], "spans": [],
                   "metrics": {},
                   "rings": {"spans": {"n_seen": seen, "n_dropped": dropped},
                             "events": {"n_seen": 0, "n_dropped": 0}}}]}


def test_launch_obs_check_gate_prints_and_counts_as_reference(capsys):
    good = {"r": [{"window": 0, "ts": 0.0, "events": [], "spans": [],
                   "metrics": {"m": {"type": "counter", "series": [
                       {"labels": {}, "value": 3}]}}}]}
    legacy = {"r": [{"window": 0, "ts": 0.0, "events": [], "spans": [],
                     "metrics": {}}]}
    cases = [(good, ["m"], None), (good, ["missing_metric"], None),
             ({}, [], None), ({"r": [{"window": 0}]}, [], None),
             ({"r": []}, [], None),
             (_run_with_rings(100, 10), [], 0.5),
             (_run_with_rings(100, 60), [], 0.5),
             (_run_with_rings(0, 0), [], 0.0), (legacy, [], 0.5),
             (legacy, [], None)]
    for runs, req, frac in cases:
        want = jlaunch.check(runs, req, frac)
        want_out = capsys.readouterr().out
        got = tlaunch.check(runs, req, frac)
        assert (got, capsys.readouterr().out) == (want, want_out)
    assert [tlaunch.check(r, q, f) for r, q, f in cases] == \
        [0, 1, 1, 1, 1, 0, 1, 0, 1, 0]


def test_port_jsonl_reads_with_either_launch_obs(tmp_path, capsys):
    """A window the port writes passes the reference's `--check` and the
    port's, and both summarize it in the same lines."""
    tobs.set_exporter(tobs.JsonlExporter(tmp_path, run="port"))
    c = tobs.counter("serve_queries_total", "queries served")
    c.inc(64)
    with tobs.span("serve", n=64):
        pass
    tobs.event("tiering_swap", generation=1, corpus_version=0)
    tobs.export_window(0)
    jruns, truns = jobs.load_dir(tmp_path), tobs.load_dir(tmp_path)
    assert jruns == truns and list(truns) == ["port"]
    req = ["serve_queries_total"]
    assert jlaunch.check(jruns, req, 0.0) == tlaunch.check(truns, req, 0.0) == 0
    capsys.readouterr()
    for mod, runs in ((jlaunch, jruns), (tlaunch, truns)):
        mod.summarize_run("port", runs["port"], show_spans=True,
                          show_events=True)
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and len(out) == 8
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, runpy; sys.argv = ['obs', '--dir', sys.argv[1], "
            "'--check', '--require-metric', 'serve_queries_total']; "
            "runpy.run_module('repro_torch.launch.obs', run_name='__main__')")
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "check ok" in done.stdout, done.stderr


# -- SLO ---------------------------------------------------------------------------

def test_slo_rule_validation_and_target_parsing():
    def run(o, slo):
        out = [err(lambda: slo.SLORule("r", "gauge:x")),
               err(lambda: slo.SLORule("r", "gauge:x", max=1.0,
                                       fast_windows=3, slow_windows=2)),
               err(lambda: slo.SLORule("r", "gauge:x", max=1.0,
                                       fast_windows=0)),
               slo._parse_target("name"),
               slo._parse_target("admission_total{decision=reject, tier=t1}"),
               err(lambda: slo._parse_target("1bad{")),
               err(lambda: slo._parse_target("name{oops}"))]
        for spec in ("nonsense:x", "no_kind_separator", "p150:h",
                     "ratio:a"):
            o.SLO.set_rules([slo.SLORule("r", spec, max=1.0)])
            out.append(err(lambda: o.SLO.evaluate(0)))
        return out
    want, got = run(jobs, jslo), run(tobs, tslo)
    assert got == want and got[0][0] == "ValueError"


def _slo_windows(o, slo):
    """The reference's SLO cases as one sequence of windows."""
    out = []
    g = o.gauge("t_slo_g", labels=("arm",))
    g.set(10.0, arm="a")
    g.set(30.0, arm="b")
    c = o.counter("t_slo_c")
    num = o.counter("t_slo_num", labels=("decision",))
    h = o.histogram("t_slo_h", buckets=(1.0, 10.0, 100.0))
    refit_s = o.gauge("t_slo_refit_s")
    refits = o.counter("t_slo_refits")
    v = o.gauge("t_slo_v")
    o.SLO.set_rules([
        slo.SLORule("all", "gauge:t_slo_g", max=100.0),
        slo.SLORule("only_b", "gauge:t_slo_g{arm=b}", max=100.0),
        slo.SLORule("ghost", "gauge:t_slo_missing", max=1.0),
        slo.SLORule("d", "delta:t_slo_c", max=10.0),
        slo.SLORule("rej", "ratio:t_slo_num{decision=reject}/t_slo_num",
                    max=0.5),
        slo.SLORule("p", "p95:t_slo_h", max=50.0),
        slo.SLORule("budget", "gauge:t_slo_refit_s", max=10.0,
                    when="delta:t_slo_refits", when_min=1.0),
        slo.SLORule("r", "gauge:t_slo_v", max=10.0, fast_windows=2,
                    slow_windows=4, fast_burn=1.0, slow_burn=0.5,
                    clear_windows=2)])
    out.append(o.SLO.segment())
    refit_s.set(99.0)
    steps = [
        lambda: (c.inc(4), h.observe_many([0.5] * 100), v.set(0.0)),
        lambda: (num.inc(3, decision="reject"), num.inc(1, decision="accept"),
                 h.observe_many([99.0] * 100), v.set(99.0)),
        lambda: (c.inc(25), num.inc(4, decision="accept"), v.set(99.0)),
        lambda: (v.set(0.0),),
        lambda: (refits.inc(), v.set(0.0)),
        lambda: (v.set(99.0),),
        lambda: (v.set(99.0),),
    ]
    for w, step in enumerate(steps):
        step()
        out.append(o.SLO.evaluate(w))
        out.append([o.SLO.breached(), o.SLO.segment(),
                    o.REGISTRY.total("slo_breaches_total")])
    out.append(o.EVENTS.to_list())
    out.append(o.REGISTRY.get("slo_breaches_total").to_dict())
    o.SLO.reset()
    out.append([o.SLO.segment(), len(o.SLO.rules)])
    return out


def test_slo_windows_transitions_and_counters_equal_reference():
    want, got = (strip(_slo_windows(o, s))
                 for o, s in ((jobs, jslo), (tobs, tslo)))
    assert got == want
    assert [(e["kind"], e["rule"], e["window"]) for e in got[-3]] == [
        ("slo_breach", "rej", 1), ("slo_breach", "p", 1),
        ("slo_breach", "r", 2), ("slo_breach", "budget", 4),
        ("slo_recovered", "r", 4), ("slo_breach", "r", 6)]
    assert got[1]["rules"]["all"]["value"] == pytest.approx(20.0)


def test_slo_default_rules_and_disabled_noop():
    def run(o, slo):
        rules = slo.default_slo_rules()
        o.SLO.set_rules(rules)
        out = [[(r.name, r.metric, r.max, r.min, r.when) for r in rules],
               o.SLO.evaluate(0), o.REGISTRY.collect()]
        o.set_enabled(False)
        return out + [o.SLO.evaluate(1), o.SLO.breached()]
    want, got = run(jobs, jslo), run(tobs, tslo)
    assert strip(got) == strip(want) and got[1]["breached"] == []


# -- the instrumented call sites --------------------------------------------------

def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


@pytest.fixture(scope="module")
def pipes():
    from repro import api as japi
    from repro_torch import api as tapi
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    return jp.mine(min_support=1e-3), tp.mine(min_support=1e-3)


def _metrics(o, names):
    m = o.REGISTRY.collect()
    return {k: m.get(k) for k in names}


SOLVER_METRICS = ("solver_selections_total", "solver_evals_total",
                  "solver_last_f")
SERVE_METRICS = ("serve_queries_total", "serve_tier1_hits_total",
                 "serve_words_total")


def test_solver_counters_and_solve_done_events_equal_reference(pipes):
    for pipe, o in zip(pipes, PLANES):
        for solver in ("greedy", "lazy", "stochastic"):
            pipe.solve(solver, budget_frac=0.5, batch_queries=1024) \
                if solver == "stochastic" else \
                pipe.solve(solver, budget_frac=0.5)
    want, got = (strip([_metrics(o, SOLVER_METRICS), o.EVENTS.to_list()])
                 for o in PLANES)
    assert got == want
    ev = got[1]
    assert [e["solver"] for e in ev] == ["greedy", "lazy-greedy",
                                         "stochastic-greedy-m1024"]
    assert all(e["kind"] == "solve_done" and e["n_selections"] > 0
               for e in ev)


def test_engine_serve_spans_counters_and_swap_event_equal_reference(pipes):
    records = []
    for pipe, o in zip(pipes, PLANES):
        pipe.solve("greedy", budget_frac=0.5)
        engine = pipe.deploy()
        o.reset()
        queries = pipe.log.queries[:64]
        got = engine.serve(queries)
        engine.serve(pipe.log.queries[64:96])
        engine.swap_tiering(engine.tiering)
        records.append([_metrics(o, SERVE_METRICS), o.SPANS.to_list(),
                        o.EVENTS.to_list(), engine.stats.to_dict(),
                        [m.tolist() for m in got], o.dashboard()])
    want, got = strip(records[0]), strip(records[1])
    assert got == want          # the dashboard's kernel words: clause_match's
    spans = {s["name"]: s for s in got[1]}
    assert {"serve", "classify", "merge"} <= set(spans)
    assert "t1_match" in spans or "t2_match" in spans
    assert got[2][-1]["kind"] == "tiering_swap"


def test_solve_and_serve_bit_identical_with_the_plane_off(pipes):
    _, tp = pipes
    runs = []
    for on in (True, False):
        tobs.set_enabled(on)
        tobs.reset()
        rs = [tp.solve(s, budget_frac=0.5).result
              for s in ("greedy", "agnostic")]
        engine = tp.deploy()
        served = engine.serve(tp.log.queries[:128])
        runs.append((rs, served, engine.stats.to_dict(),
                     tobs.REGISTRY.collect(), len(tobs.SPANS.ring)))
    (r_on, s_on, st_on, m_on, n_on), (r_off, s_off, st_off, m_off, n_off) = runs
    for a, b in zip(r_on, r_off):
        assert a.order == b.order and a.f_final == b.f_final
        assert a.g_final == b.g_final and a.n_exact_evals == b.n_exact_evals
        np.testing.assert_array_equal(a.selected, b.selected)
    for a, b in zip(s_on, s_off):
        np.testing.assert_array_equal(a, b)
    assert st_on == st_off
    assert m_on and n_on > 0 and m_off == {} and n_off == 0


# -- the kernel ops' cost accounting ------------------------------------------------

def _op_inputs():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, (32, 4), dtype=np.uint32)
    x = rng.standard_normal((4 * 32, 2)).astype(np.float32)
    mask = rng.integers(0, 2 ** 32, 4, dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, (8, 4), dtype=np.uint32)
    ids = rng.integers(0, 50, (16, 6)).astype(np.int32)
    toks = rng.integers(-1, 5, (8, 3)).astype(np.int32)
    post = rng.integers(0, 2 ** 32, (5, 4), dtype=np.uint32)
    return a, x, mask, q, ids, toks, post


def _call_ops(ops, conv, a, x, mask, q, ids, toks, post, mask2):
    ops.bit_matvec(conv(a), conv(x))
    ops.coverage_gain(conv(a), conv(mask))
    ops.clause_match(conv(q), conv(a[:3]))
    ops.clause_match(conv(q), conv(a[:0]))      # empty: never dispatched
    ops.partition_gain(conv(a), conv(mask), (0, 2, 4))
    ops.sparse_gain(conv(ids), conv(mask2))
    ops.fused_match(conv(q), conv(a[:3]), conv(toks), conv(post), conv(post))


def _kernel_series(o):
    out = {}
    for name in ("kernel_words_scanned_total", "kernel_bytes_moved_total"):
        inst = o.REGISTRY.get(name)
        out[name] = {(s["labels"]["op"], s["labels"]["path"]): s["value"]
                     for s in inst.to_dict()["series"]}
    return out


def test_ops_word_and_byte_counts_equal_reference():
    from repro.kernels import ops as jops
    from repro_torch.core import bitset
    from repro_torch.kernels import ops as tops
    args = _op_inputs()
    mask2 = np.zeros(2, np.uint32)

    def tconv(v):
        return bitset.to_tensor(v, "cpu") if v.dtype == np.uint32 \
            else torch.from_numpy(v)

    _call_ops(jops, jnp.asarray, *args, mask2)
    _call_ops(tops, tconv, *args, mask2)
    want, got = _kernel_series(jobs), _kernel_series(tobs)
    for name in want:
        assert {op: v for (op, path), v in got[name].items()} == \
            {op: v for (op, path), v in want[name].items()}
        assert {path for _, path in got[name]} == {"cpu"}
    words = {op: v for (op, _), v in got["kernel_words_scanned_total"].items()}
    assert words["bit_matvec"] == 32 * 4 and words["partition_gain"] == 32 * 4 + 4
    assert words["clause_match"] == (8 + 3) * 4


def test_kernel_profiler_measuring_summary_and_disabled():
    from repro_torch.core import bitset
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    a = bitset.to_tensor(rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32),
                         "cpu")
    mask = bitset.to_tensor(rng.integers(0, 2 ** 32, 8, dtype=np.uint32),
                            "cpu")
    on = ops.coverage_gain(a, mask)
    assert tobs.REGISTRY.total("kernel_words_scanned_total") == 64 * 8
    assert tobs.PROFILER.summary() == []        # not measuring: no rows
    with tobs.PROFILER.scoped():
        with tobs.PROFILER.measuring():
            ops.coverage_gain(a, mask)
            ops.coverage_gain(a, mask)
        rows = tobs.PROFILER.summary()
    assert tobs.PROFILER.summary() == []        # the scope restored the empty agg
    assert [(r["op"], r["path"], r["calls"]) for r in rows] == \
        [("coverage_gain", "cpu", 2)]
    r = rows[0]
    assert r["words_scanned"] == 2 * 64 * 8
    assert r["bytes_moved"] == 2 * 4 * (64 * 8 + 8 + 64)
    assert r["roofline_frac"] == pytest.approx(
        r["achieved_gbps"] / (tobs.HBM_BW / 1e9), abs=1e-6)
    assert tobs.HBM_BW == 3.35e12 and tobs.PEAK_FLOPS == 989e12
    tobs.set_enabled(False)
    off = ops.coverage_gain(a, mask)
    assert torch.equal(on, off)
    with tobs.PROFILER.measuring():
        ops.coverage_gain(a, mask)
    assert tobs.PROFILER.summary() == []
    assert tobs.REGISTRY.total("kernel_words_scanned_total") == 64 * 8 * 3
