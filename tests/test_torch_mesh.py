"""The port's shard mesh against the reference, on 4 CPU mesh entries.

The port's fused serve (`cluster.mesh_serve`) and owner-local
`partition_gain` run under `distributed.use_mesh(shard_mesh(4, "cpu"))`,
the role the reference's tests give 4 forced host devices in a subprocess
(`tests/test_mesh.py`, `tests/test_frontend.py`, `tests/test_ingest.py`).
Each case holds the port's fused path to the reference's host path in
this process, on the same inputs: match sets bit for bit, `ServeStats`,
every `BatchTrace` and the replicas' counters; `partition_gain` to
`ops._partition_gain_xla`; the partitioned solve's order and `g_part`. The
solves mine the log with its weights as counts over a power-of-two
denominator (exact f32 sums, ROADMAP fault 1; tests/test_torch_solvers.py).

The reference's backend-resolution tests (`REPRO_KERNEL_BACKEND`,
`resolve_backend`, per-op placement) have no counterpart: in the port the
operands' device picks the route and there is no placement to resolve.
"""
import copy
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import cluster as jcluster
from repro import distributed as jdist
from repro.core import SOLVERS
from repro.core.tiering import ClauseTiering as JTiering
from repro.data import incidence as jinc
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch import cluster as tcluster
from repro_torch import convert
from repro_torch import distributed as tdist
from repro_torch import ingest as tingest
from repro_torch import obs as tobs
from repro_torch.core import bitset
from repro_torch.data import incidence as tinc
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def mesh4():
    return tdist.use_mesh(tdist.shard_mesh(4, device_type="cpu"))


def dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


def tierings(data, problem, budget_frac=0.5):
    """The reference's greedy tiering and its copy for the port."""
    r = SOLVERS["greedy"](problem, int(data.n_docs * budget_frac))
    jt = JTiering.from_selection(data, r.selected)
    return jt, convert.tiering_from_numpy(jt.clauses, jt.clause_vocab_bits,
                                          jt.tier1_docs, jt.vocab_size)


def fleets(data, pair, **kw):
    """(reference fleet, port fleet on the CPU) over the same postings."""
    jt, tt = pair
    return (jcluster.TieredCluster(data.postings, jt, data.n_docs, **kw),
            tcluster.TieredCluster(data.postings, tt, data.n_docs,
                                   device="cpu", **kw))


def same_sets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def replicas(fleet):
    return [(r.tier, r.shard.index, r.generation, r.content, r.draining,
             r.n_batches, r.n_queries, r.words_scanned, r.n_installs)
            for groups in (fleet.router.t1, fleet.router.t2)
            for g in groups for r in g]


def same_fleet(t, j):
    """Stats, every retained BatchTrace and every replica's counters."""
    assert t.stats.to_dict() == j.stats.to_dict()
    assert [dataclasses.astuple(x) for x in t.trace] == \
        [dataclasses.astuple(x) for x in j.trace]
    assert replicas(t) == replicas(j)
    assert t.consistency_ok() and j.consistency_ok()


def serve_fused(pair, batch):
    """One batch: the reference's host path, the port's fused path under
    the 4-entry mesh, and the port's oracle must agree."""
    jf, tf = pair
    want = jf.serve(batch)
    with mesh4():
        got = tf.serve(batch)
    same_sets(got, want)
    same_sets(got, tf.serve_reference(batch))
    return got


# -- the plan and the gate ---------------------------------------------------------

def test_current_plan_single_device_defaults():
    got, want = tdist.current_plan(), jdist.current_plan()
    assert got.shard_axis is None is want.shard_axis
    assert not got.shard_fused and not want.shard_fused
    assert got.n_shard_devices == want.n_shard_devices == 1
    assert tdist.current_mesh().size == 1
    with mesh4():
        plan = tdist.current_plan()
        assert plan.shard_axis == tdist.SHARD_AXIS and plan.shard_fused
        assert plan.n_shard_devices == 4
        assert plan.mesh.devices == (torch.device("cpu"),) * 4
    assert tdist.current_mesh().size == 1          # restored on exit


def test_mesh_fused_gates_off_mesh():
    from jax.sharding import PartitionSpec as P
    assert tdist.mesh_fused(lambda devs, x: x) is None
    assert jdist.mesh_fused(lambda x: x, in_specs=(P(),), out_specs=P()) \
        is None
    with tdist.use_mesh(tdist.shard_mesh(1, device_type="cpu")):
        plan = tdist.current_plan()
        assert plan.shard_axis == "shard" and not plan.shard_fused
        assert tdist.mesh_fused(lambda devs, x: x) is None
    with mesh4():
        run = tdist.mesh_fused(lambda devs, x: (len(devs), x))
        assert run(7) == (4, 7)
    with tdist.use_mesh(tdist.Mesh("model", (torch.device("cpu"),) * 4)):
        assert not tdist.current_plan().shard_fused
        assert tdist.mesh_fused(lambda devs: devs) is None
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        tdist.shard_mesh(2, device_type="tpu")
    assert [list(r) for r in tdist.blocks(5, 4)] == [[0, 1], [2, 3], [4], []]
    assert [list(r) for r in tdist.blocks(3, 4)] == [[0], [1], [2], []]


def test_serve_host_path_on_one_entry_shard_mesh(tiny_data, tiny_problem):
    """A size-1 shard mesh leaves serving on the host path: no table."""
    jf, tf = fleets(tiny_data, tierings(tiny_data, tiny_problem),
                    n_shards=2, t1_replicas=2)
    queries = tiny_data.log.queries[:64]
    with tdist.use_mesh(tdist.shard_mesh(1, device_type="cpu")):
        got = tf.serve(queries)
    same_sets(got, jf.serve(queries))
    same_sets(got, tf.serve_reference(queries))
    assert not tf.router._mesh_tables
    same_fleet(tf, jf)


# -- partition_gain on the mesh ----------------------------------------------------

@pytest.mark.parametrize("bounds", [(0, 3, 4, 9, 13), (0, 13),
                                    (0, 1, 2, 3, 4, 5, 6, 13)])
def test_partition_gain_owner_local_equals_reference(monkeypatch, bounds):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (37, 13), dtype=np.uint32)
    m = rng.integers(0, 2 ** 32, (13,), dtype=np.uint32)
    want = np.asarray(jops._partition_gain_xla(jnp.asarray(a), jnp.asarray(m),
                                               bounds))
    calls = []
    mesh_path = ops._partition_gain_mesh
    monkeypatch.setattr(ops, "_partition_gain_mesh",
                        lambda *args: calls.append(1) or mesh_path(*args))
    prev = tobs.set_enabled(True)
    try:
        with mesh4(), tobs.PROFILER.scoped(), tobs.PROFILER.measuring():
            got = ops.partition_gain(bitset.to_tensor(a, "cpu"),
                                     bitset.to_tensor(m, "cpu"), bounds)
            rows = tobs.PROFILER.summary()
    finally:
        tobs.set_enabled(prev)
    assert calls == [1]
    assert [(r["op"], r["path"]) for r in rows] == [("partition_gain", "mesh")]
    assert got.dtype == torch.int32 and got.shape == (37, len(bounds) - 1)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = ops.partition_gain(bitset.to_tensor(a, "cpu"),
                                bitset.to_tensor(m, "cpu"), bounds)
    assert torch.equal(direct, got)


def test_partition_gain_on_the_mesh_needs_operands_on_its_first_entry():
    """The columns are gathered on the first entry: operands elsewhere are
    refused, never moved in silence."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    m = torch.zeros(8, dtype=torch.int32)
    with tdist.use_mesh(tdist.Mesh("shard", (torch.device("meta"),) * 2)):
        with pytest.raises(ValueError, match="gathers its result on meta"):
            ops.partition_gain(a, m, (0, 4, 8))


# -- fused serve == host path == the oracle ------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("reps", [1, 2, 4])
def test_fused_serve_equals_host_path(tiny_data, tiny_problem, n_shards, reps):
    pair = fleets(tiny_data, tierings(tiny_data, tiny_problem),
                  n_shards=n_shards, t1_replicas=reps, t2_replicas=reps)
    queries = tiny_data.log.queries[:192]
    for s in range(0, len(queries), 64):
        serve_fused(pair, queries[s:s + 64])
    jf, tf = pair
    same_fleet(tf, jf)
    assert tf.router._mesh_tables, "fused path never engaged"
    table = next(iter(tf.router._mesh_tables.values()))
    assert table.bytes_added == 0          # every entry is the fleet's CPU
    assert sum(len(o) for o in table.owned) == n_shards


@pytest.mark.parametrize("n_shards", [3, 5])
def test_fused_serve_uneven_shards_on_four_entries(tiny_data, tiny_problem,
                                                   n_shards):
    """Shard counts that do not divide the entries, uneven and one-word
    shards: an entry owns none, and no block touches a neighbour's words."""
    pair = fleets(tiny_data, tierings(tiny_data, tiny_problem),
                  n_shards=n_shards, t1_replicas=2)
    jf, tf = pair
    assert len({s.n_words for s in tf.shards}) > 1
    queries = tiny_data.log.queries
    for s in range(0, len(queries), 128):
        serve_fused(pair, queries[s:s + 128])
    same_fleet(tf, jf)
    (table,) = tf.router._mesh_tables.values()
    owned = [[sh.word_lo for sh in o] for o in table.owned]
    assert [len(o) for o in owned] == [len(r) for r in tdist.blocks(n_shards, 4)]
    assert owned[-1] == []


def test_fused_rolling_swap_through_the_tier2_fallback(tiny_data, tiny_problem):
    t_new = tierings(tiny_data, tiny_problem, budget_frac=0.25)
    pair = fleets(tiny_data, tierings(tiny_data, tiny_problem),
                  n_shards=2, t1_replicas=1)
    jf, tf = pair
    queries = tiny_data.log.queries[:64]
    serve_fused(pair, queries)
    assert tf.swap_tiering(t_new[1]) == jf.swap_tiering(t_new[0]) == 1
    fallback = batches = 0
    while tf.router.rollout is not None and batches < 64:
        serve_fused(pair, queries)
        fallback += tf.trace[-1].psi_generation == -1
        batches += 1
    assert fallback > 0, "expected a Tier-2 fallback window"
    assert jf.router.rollout is None
    serve_fused(pair, queries)
    assert tf.trace[-1].psi_generation == 1 and tf.trace[-1].n_tier1 > 0
    same_fleet(tf, jf)
    # the evicted generation's tables went with its buffer
    assert {k[0] for k in tf.router._mesh_tables} <= set(tf.router._buffers)


def test_partitioned_solve_identity_on_the_mesh(monkeypatch):
    jp = japi.TieringPipeline.from_synthetic(0, "tiny")
    tp = tapi.TieringPipeline.from_synthetic(0, "tiny", device="cpu")
    dyadic(jp.log)
    dyadic(tp.log)
    jp.mine(min_support=1e-3)
    tp.mine(min_support=1e-3)
    kw = dict(budget_frac=0.5, budget_split="traffic", n_shards=4)
    want = jp.solve("greedy", **kw).result
    cold = tp.solve("greedy", **kw).result
    calls = []
    mesh_path = ops._partition_gain_mesh
    monkeypatch.setattr(ops, "_partition_gain_mesh",
                        lambda *args: calls.append(1) or mesh_path(*args))
    with mesh4():
        fused = tp.solve("greedy", **kw).result
    assert calls, "the mesh path never ran"
    assert fused.order == cold.order == want.order and len(want.order) > 10
    assert fused.extra["g_part"].tobytes() == want.extra["g_part"].tobytes()
    assert fused.extra["caps"].tobytes() == want.extra["caps"].tobytes()


# -- the front-end cache mid-rollout, fused --------------------------------------------

def test_fused_cache_parity_mid_rollout(tiny_data, tiny_problem):
    """A cached and an uncached fleet, both fused, against the reference's
    cached host fleet: equal answers, stats and traces through a rolling
    swap, an all-hit warm pass, then a batch whose misses alone are
    served fused."""
    pair = tierings(tiny_data, tiny_problem)
    t_new = tierings(tiny_data, tiny_problem, budget_frac=0.25)
    kw = dict(n_shards=2, t1_replicas=2)
    jf, cached = fleets(tiny_data, pair, cache=True, **kw)
    _, plain = fleets(tiny_data, pair, cache=False, **kw)
    queries = tiny_data.log.queries[:64]

    def serve_all():
        want = jf.serve(queries)
        with mesh4():
            a, b = cached.serve(queries), plain.serve(queries)
        same_sets(a, want)
        same_sets(b, want)
        same_sets(a, cached.serve_reference(queries))

    serve_all()                       # cold cache: every query misses
    assert cached.stats.to_dict() == plain.stats.to_dict()
    jf.swap_tiering(t_new[0])
    cached.swap_tiering(t_new[1])
    plain.swap_tiering(t_new[1])
    batches = 0
    while cached.router.rollout is not None and batches < 64:
        serve_all()
        batches += 1
    assert plain.router.rollout is None and jf.router.rollout is None
    serve_all()                       # warm pass at the landed generation
    assert cached.trace[-1].n_cached == len(queries)
    mixed = tiny_data.log.queries[32:128]     # half cached: misses fused
    want = jf.serve(mixed)
    with mesh4():
        got = cached.serve(mixed)
    same_sets(got, want)
    assert 0 < cached.trace[-1].n_cached < len(mixed)
    assert cached.cache.stats.hits > 0 and cached.cache.stats.invalidations > 0
    assert cached.cache.snapshot() == jf.cache.snapshot()
    same_fleet(cached, jf)
    assert cached.router._mesh_tables and plain.router._mesh_tables


# -- three ingest corpus versions, fused -------------------------------------------

def test_fused_ingest_mirror_over_three_corpus_versions():
    """A fused fleet rolling through three corpus appends equals the
    reference's host fleet batch for batch, and a fused stop-the-world
    mirror at the version each batch was served at."""
    pipes = []
    for api, inc in ((japi, jinc), (tapi, tinc)):
        kw = {} if api is japi else dict(device="cpu")
        p = api.TieringPipeline.from_synthetic(0, "tiny", **kw)
        dyadic(p.log)
        p.mine(min_support=1e-3).solve("greedy", budget_frac=0.5,
                                       budget_split="traffic", n_shards=2)
        pipes.append((p, inc))
    (jp, _), (tp, _) = pipes
    assert tp.result.order == jp.result.order
    kw = dict(n_shards=2, t1_replicas=2, t2_replicas=2)
    jroll = jp.deploy_cluster(**kw)
    roller, mirror = tp.deploy_cluster(**kw), tp.deploy_cluster(**kw)
    feed = tingest.DocumentFeed(log=tp.log, vocab_size=tp.corpus.vocab_size,
                                rate=48.0, seed=7)
    queries = tp.log.queries[:64]
    snaps, applied, mid_rollout = {}, 0, 0
    for t in range(3):
        docs = list(feed.window(t))
        for pipe, inc in pipes:
            delta = inc.append_docs(pipe.data, docs)
            pipe.problem = pipe.problem.with_doc_block(delta.clause_cols,
                                                       delta.n_docs)
            pipe.adopt_selection(pipe.problem.state_for(
                np.nonzero(np.asarray(pipe.result.selected))[0]))
        jroll.swap_corpus(jp.data.postings, jp.data.n_docs, jp.tiering())
        tiering = tp.tiering()
        roller.swap_corpus(tp.data.postings, tp.data.n_docs, tiering)
        snaps[roller.corpus_version] = (copy.deepcopy(tp.data.postings),
                                        tp.data.n_docs, tiering)
        batches = 0
        while True:
            want = jroll.serve(queries)
            with mesh4():
                got = roller.serve(queries)
                served = roller.trace[-1].corpus_version
                mid_rollout += served < roller.corpus_version
                while applied < served:
                    applied += 1
                    p, n, tg = snaps[applied]
                    mirror.swap_corpus(p, n, tg, immediate=True)
                same_sets(got, mirror.serve(queries))
            same_sets(got, want)
            same_sets(got, roller.serve_reference(queries,
                                                  corpus_version=served))
            batches += 1
            if roller.router.rollout is None or batches >= 64:
                break
        assert roller.router.rollout is None, "rollout never completed"
    assert mid_rollout > 0, "never observed a mid-rollout batch"
    assert applied == roller.corpus_version == 3
    same_fleet(roller, jroll)
    assert mirror.consistency_ok()
    assert roller.router._mesh_tables and mirror.router._mesh_tables
    # tables follow the corpus version: none outlives its buffer
    assert {k[1] for k in roller.router._mesh_tables} == {3}


# -- the launcher ----------------------------------------------------------------------

def test_cluster_launcher_mesh_verify_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--mesh",
         "--verify", "--scale", "tiny", "--device", "cpu", "--obs-dir", "",
         "--windows", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "mesh: 4 entries on axis 'shard' (cpu, cpu, cpu, cpu)" in out.stdout
    assert "fused serve ON" in out.stdout
    assert "served fused on the mesh" in out.stdout
