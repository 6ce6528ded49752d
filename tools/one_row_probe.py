"""Where the time of a one-row exact evaluation goes, and which route of
`coverage_gain` and `bit_matvec` a call of C rows should take; the same
for `partition_gain` under per-shard caps.

    python3 tools/one_row_probe.py [--root DIR] [--seed 0]
                                   [--parts offer,lazy,ab,eval,launch,sweep]
                                   [--tag NAME] [--out DIR]

Needs one CUDA card. `--root` names the checkout whose `src/` and
`chip_smoke.py` are imported (default: this one), so two commits can be
compared in one call on one card: unpack the other with `git archive` into
a directory that `.gitignore` lists and run both in turns.

The operands are `chip_smoke.py` phase 3's (2^16 clauses, 2^20 queries and
docs, W = 32768 words a row), at the state after greedy's first `--prefix`
selections (6: lazy's prefix when its 30 s run stops; lazy == greedy up to
f32 ties), and 64 clauses drawn from `--seed`. The per-shard forms take
`chip_smoke.py` phase 3's 8 shard caps, built as `phase3_shards` builds
them (each shard capped at half of the global greedy's fill there after its
128 selections, so the caps bind), as a `PartitionedBudget`.

- `eval`: the nnz of the 64 clauses' query and doc rows; each one-row
  kernel over them, by route where the checkout has routes: CUDA-event ms a
  call (the wrapper's host work included; median of 64 launches) and
  device ms (a CUDA graph of the 64 calls); the launch floor (an empty
  kernel through `_build.launch`'s path, where the checkout has one); one
  `_exact_gains_one` (lazy's unit of work) on the host clock, and the same
  64 evaluations under `torch.profiler`: the device time an evaluation by
  kernel or copy, so that the host's share is the wall time less it.
  Per-shard form (`shard`): one-row `partition_gain` by route where the
  checkout has routes (event and device ms), and the exact evaluation
  under the caps on the host clock, under the profiler, and the kernel
  launches it makes.
- `launch`: host µs a launch (perf_counter over 512 launches, then one
  sync) of an empty kernel by <<<>>>, by cudaLaunchKernelEx without and
  with a cluster dimension (the split route's launch), and of a kernel
  compiled with __cluster_dims__(8) (`tools/one_row_launch.cu`); the same
  for a one-row wrapper call on each route the checkout has. Per-shard
  form (`shard`): the host µs of each part of a one-row `partition_gain`
  call (`ops.partition_gain`, its mesh gate and tile lookup, the wrapper,
  its bounds check, the output's allocation, `_build.launch`, its device
  context and stream lookup, the ctypes call alone, the telemetry plane's
  record, the call and the evaluation with the plane off) and of the
  evaluation's other steps where the checkout makes them (the f32 cast,
  the sum, the concatenation, the host read).
- `ab` (a checkout with routes only): `eval`'s exact evaluation, `offer`
  and `lazy` with each route forced in one process, in turns (warp, split,
  split, warp), so that the host's own spread drops out of the comparison.
- `lazy`: two lazy selections from the empty state: ms a selection, exact
  evaluations; and (`shard`) two under the caps.
- `offer`: an ingest offer's gain reads (`IngestController._admit`'s body
  for one clause: its one-row f-gain under the problem's weights, its
  one-row g-gains, the used budget and feasibility, three host reads) over
  the 64 clauses, three passes: ms an offer.
- `sweep` (a checkout with routes only): device ms of both routes at C =
  1, 2, 4, ... 4096 at W = 32768 (the phase-3 rows), at `medium`'s widths
  (849 query words, 625 doc words) and at 1024 ... 16384 (the phase-3 rows
  cut to them): the first C rows (the most popular clauses, the densest)
  and, for `bit_matvec`, whose time follows the set bits, also C rows drawn
  from seed 1; timed in turns (warp,
  split, split, warp); and the split route's cluster sizes at C = 1.

Prints one JSON line per part and writes them to
`<out>/one_row_probe_<tag>.json` (default `build/probe`), then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM = 3.35e12
MEDIUM_WIDTHS = {"bit_matvec": 849, "coverage_gain": 625}
SWEEP_WIDTHS = (1024, 2048, 4096, 8192, 16384)   # between them


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix", type=int, default=6)
    ap.add_argument("--parts", default="offer,lazy,ab,eval,launch,sweep")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "build" / "probe"))
    return ap.parse_args(argv)


def event_ms(calls) -> float:
    """Median CUDA-event ms of one call, each of `calls` bracketed alone."""
    calls[0]()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in calls]
    for (a, b), fn in zip(ev, calls):
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def graph_ms(calls) -> float:
    """Device ms a call: `calls` captured in one CUDA graph, replayed
    between two CUDA events (the wrappers' host work drops out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for fn in calls:
            fn()
    g.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / len(calls)


def routes_of(fn) -> list:
    return ["warp", "split"] if "route" in inspect.signature(fn).parameters else [None]


def kw(route) -> dict:
    return {} if route is None else {"route": route}


def part_eval(p3, st, js, x) -> dict:
    from repro_torch.core.constraint import GlobalBudget
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bit_matvec import bit_matvec
    from repro_torch.kernels.coverage_gain import coverage_gain
    problem = p3["problem"]
    aq, ad = problem.clause_query_bits, problem.clause_doc_bits
    idx = torch.tensor(js, device=aq.device)
    out = dict(rows=len(js), words=int(aq.shape[1]),
               nnz_query=ops.coverage_gain(aq[idx], torch.zeros_like(aq[0])).tolist(),
               nnz_doc=ops.coverage_gain(ad[idx], torch.zeros_like(ad[0])).tolist(),
               uncovered_doc=ops.coverage_gain(ad[idx], st.covered_d).tolist())
    xc = x[:, None]
    for route in routes_of(coverage_gain):
        tag = route or "warp"
        cg = [lambda j=j: coverage_gain(ad[j:j + 1], st.covered_d, **kw(route)) for j in js]
        bm = [lambda j=j: bit_matvec(aq[j:j + 1], xc, **kw(route)) for j in js]
        out[f"coverage_gain_{tag}"] = dict(event_ms=event_ms(cg), device_ms=graph_ms(cg))
        out[f"bit_matvec_{tag}"] = dict(event_ms=event_ms(bm), device_ms=graph_ms(bm))
    if hasattr(_build, "launch_floor"):
        dev = aq.device
        fl = [lambda: _build.launch_floor(dev)] * len(js)
        out["launch_floor"] = dict(event_ms=event_ms(fl), device_ms=graph_ms(fl))
    else:
        out["launch_floor"] = "not in this checkout"
    out.update(evaluation(problem, GlobalBudget(p3["budget"]), x, st, js))
    return out


def evaluation(problem, cons, x, st, js) -> dict:
    """One `_exact_gains_one` under `cons` over the clauses `js`: host-clock
    ms (median, mean), the kernel launches an evaluation makes, and the same
    evaluations under the profiler (device ms an evaluation by kernel or
    copy; the host's share is the wall time less it)."""
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import _build
    out = {}
    _exact_gains_one(problem, cons, x, st.covered_d, js[0])
    _build.reset_launches()
    wall = []
    for j in js:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _exact_gains_one(problem, cons, x, st.covered_d, j)
        wall.append((time.perf_counter() - t) * 1e3)
    out["exact_eval_ms"] = statistics.median(wall)
    out["exact_eval_mean_ms"] = statistics.fmean(wall)
    out["launches_an_eval"] = {k: v / len(js) for k, v in _build.LAUNCHES.items() if v}
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for j in js:
            _exact_gains_one(problem, cons, x, st.covered_d, j)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t) * 1e3 / len(js)
    dev_items, dev_calls = {}, {}
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", None)
        if d is None:
            d = getattr(e, "self_cuda_time_total", 0)
        if d and e.device_type.name == "CUDA":
            dev_items[e.key] = d / 1e3 / len(js)
            dev_calls[e.key] = e.count / len(js)
    dev = sum(dev_items.values())
    out["profiled"] = dict(wall_ms=traced, device_ms=dev, host_ms=traced - dev,
                           device_items=dict(sorted(dev_items.items(), key=lambda kv: -kv[1])),
                           device_calls_an_eval=dev_calls)
    out["split"] = dict(wall_ms=out["exact_eval_mean_ms"], device_ms=dev,
                        host_ms=out["exact_eval_mean_ms"] - dev)
    return out


def shard_caps(p3, n_parts: int):
    """`chip_smoke.phase3_shards`' constraint: `n_parts` word-aligned shards,
    each capped at half of the global greedy's fill there after its 128
    selections."""
    import numpy as np

    from repro_torch.core import bitset
    from repro_torch.core.constraint import PartitionedBudget, partition_bounds
    problem, state = p3["problem"], p3["state"]
    bounds = partition_bounds(problem.n_docs, n_parts)
    covered = bitset.to_numpy(state.covered_d)
    fills = np.array([bitset.np_popcount(covered[lo:hi])
                      for lo, hi in zip(bounds, bounds[1:])], np.float64)
    return PartitionedBudget(fills / 2, bounds)


def part_eval_shard(p3, st, js, x, cons) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.partition_gain import partition_gain
    problem = p3["problem"]
    ad = problem.clause_doc_bits
    bounds = cons.bounds
    out = dict(rows=len(js), words=int(ad.shape[1]), parts=len(bounds) - 1,
               bounds=list(bounds), caps=cons.caps.tolist())
    for route in routes_of(partition_gain):
        calls = [lambda j=j: partition_gain(ad[j:j + 1], st.covered_d, bounds, **kw(route))
                 for j in js]
        out[f"partition_gain_{route or 'warp'}"] = dict(event_ms=event_ms(calls),
                                                        device_ms=graph_ms(calls))
    calls = [lambda j=j: ops.partition_gain(ad[j:j + 1], st.covered_d, bounds) for j in js]
    out["ops_partition_gain"] = dict(event_ms=event_ms(calls), device_ms=graph_ms(calls))
    out.update(evaluation(problem, cons, x, st, js))
    return out


def host_us(fn, n: int = 512) -> float:
    """Host µs a call of `fn` (no sync between calls)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def part_launch(p3, st, js, x) -> dict:
    import ctypes

    from repro_torch.kernels import bit_matvec as bm
    from repro_torch.kernels import coverage_gain as cgm
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import nvcc_lib
    lib = nvcc_lib.load(Path(__file__).resolve().parent / "one_row_launch.cu", "launch")
    for name, args in (("launch_plain", [ctypes.c_int, ctypes.c_void_p]),
                       ("launch_ex", [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
                       ("launch_static8", [ctypes.c_int, ctypes.c_void_p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    s = torch.cuda.current_stream().cuda_stream
    out = {"styles_us": {
        "plain_8_ctas": host_us(lambda: lib.launch_plain(8, s)),
        "ex_no_cluster_8_ctas": host_us(lambda: lib.launch_ex(8, 0, s)),
        "ex_cluster_8": host_us(lambda: lib.launch_ex(8, 8, s)),
        "ex_cluster_2": host_us(lambda: lib.launch_ex(2, 2, s)),
        "static_cluster_8": host_us(lambda: lib.launch_static8(8, s)),
    }}
    problem = p3["problem"]
    aq, ad = problem.clause_query_bits, problem.clause_doc_bits
    j = js[1]
    xc = x[:, None]
    routes = routes_of(cgm.coverage_gain)
    out["wrapper_us"] = {
        f"{k}_{r or 'warp'}": host_us(lambda k=k, r=r: (
            cgm.coverage_gain(ad[j:j + 1], st.covered_d, **kw(r)) if k == "coverage_gain"
            else bm.bit_matvec(aq[j:j + 1], xc, **kw(r))))
        for k in ("coverage_gain", "bit_matvec") for r in routes}
    return out


def part_launch_shard(p3, st, js, x, cons) -> dict:
    """Host µs of each part of a one-row `partition_gain` call under the
    caps' bounds, and of the evaluation's other steps."""
    from repro_torch import distributed as dist
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import _build, autotune, ops
    from repro_torch.kernels import partition_gain as pgm
    problem = p3["problem"]
    j = js[1]
    row, mask, bounds = problem.clause_doc_bits[j:j + 1], st.covered_d, cons.bounds
    dev, w, p = row.device, row.shape[1], len(bounds) - 1
    lib = _build.lib()
    out_t = torch.empty((1, p), dtype=torch.int32, device=dev)
    dev_b = torch.tensor(bounds, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw(lib_, s):
        return lib_.partition_gain_launch(row.data_ptr(), mask.data_ptr(), dev_b.data_ptr(),
                                          out_t.data_ptr(), 1, w, p, 0, 8, s)

    def context():
        with torch.cuda.device(dev):
            pass

    g_f = out_t.to(torch.float32)
    f = torch.zeros(1, device=dev)
    read = torch.zeros(1 + p, device=dev)
    from repro_torch import obs
    plane = obs.set_enabled(False)
    try:
        plane_off = {
            "exact_eval_plane_off": host_us(
                lambda: _exact_gains_one(problem, cons, x, mask, j), 256),
            "ops_partition_gain_plane_off": host_us(lambda: ops.partition_gain(row, mask, bounds)),
        }
    finally:
        obs.set_enabled(plane)
    parts = {
        **plane_off,
        "ops_obs_record": host_us(lambda: ops._profiler().record("partition_gain", "cuda", 1, 1)),
        "exact_eval": host_us(lambda: _exact_gains_one(problem, cons, x, mask, j), 256),
        "ops_partition_gain": host_us(lambda: ops.partition_gain(row, mask, bounds)),
        "ops_mesh_gate_and_tile_lookup": host_us(lambda: (
            dist.mesh_fused(ops._partition_gain_mesh),
            dist.current_plan().tile_params("partition_gain", "cuda",
                                            autotune.bucket("partition_gain", 1, w, p)))),
        "wrapper": host_us(lambda: pgm.partition_gain(row, mask, bounds)),
        "wrapper_check_bounds": host_us(lambda: pgm.check_bounds(bounds, w)),
        "wrapper_require": host_us(lambda: (
            _build.require(row, "a_bits", torch.int32, 2),
            _build.require(mask, "mask", torch.int32, 1, dev))),
        "alloc_out": host_us(lambda: torch.empty((1, p), dtype=torch.int32, device=dev)),
        "build_launch": host_us(lambda: _build.launch("partition_gain", dev, raw)),
        "device_context": host_us(context),
        "stream_lookup": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "current_device": host_us(torch.cuda.current_device),
        "ctypes_call": host_us(lambda: raw(lib, stream)),
        "data_ptrs": host_us(lambda: (row.data_ptr(), mask.data_ptr(), dev_b.data_ptr(),
                                      out_t.data_ptr())),
        "eval_cast": host_us(lambda: out_t.to(torch.float32)),
        "eval_sum": host_us(lambda: g_f.sum(-1)),
        "eval_cat": host_us(lambda: torch.cat([f, g_f[0]])),
        "eval_host_read": host_us(lambda: read.tolist(), 256),
    }
    return {"parts_us": parts}


def part_ab(p3, st, js, x) -> dict:
    """The host-bound paths with each route forced in one process, in turns
    (warp, split, split, warp): one exact evaluation over the 64 clauses,
    an offer (`part_offer`) and two lazy selections (`part_lazy`)."""
    import functools

    from repro_torch.core.constraint import GlobalBudget
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import bit_matvec as bm
    from repro_torch.kernels import coverage_gain as cgm
    problem = p3["problem"]
    cons = GlobalBudget(p3["budget"])
    orig = (bm.bit_matvec, cgm.coverage_gain)
    out = {r: {"eval_ms": [], "offer_ms": [], "lazy_ms_a_selection": []}
           for r in ("warp", "split")}
    try:
        for r in ("warp", "split", "split", "warp"):
            bm.bit_matvec = functools.partial(orig[0], route=r)
            cgm.coverage_gain = functools.partial(orig[1], route=r)
            _exact_gains_one(problem, cons, x, st.covered_d, js[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            for j in js:
                _exact_gains_one(problem, cons, x, st.covered_d, j)
            out[r]["eval_ms"].append((time.perf_counter() - t) * 1e3 / len(js))
            out[r]["offer_ms"].append(part_offer(p3, st, js)["ms_an_offer"])
            lz = part_lazy(p3)
            out[r]["lazy_ms_a_selection"].append(lz["ms_a_selection"])
            out[r]["lazy_order"] = lz["order"]
    finally:
        bm.bit_matvec, cgm.coverage_gain = orig
    return out


def part_ab_shard(p3, st, js, x, cons) -> dict:
    """The evaluation and two lazy selections under the caps with
    `partition_gain`'s route forced, in turns (warp, split, split, warp),
    through `tiles`' route limits (`bit_matvec` on the route its shape
    picks)."""
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import tiles
    problem = p3["problem"]
    saved = (dict(tiles.SPLIT_MAX_TASKS), dict(tiles.SPLIT_MIN_WORDS))
    out = {r: {"eval_ms": [], "lazy_ms_a_selection": []} for r in ("warp", "split")}
    try:
        for r in ("warp", "split", "split", "warp"):
            tiles.SPLIT_MAX_TASKS["partition_gain"] = 1 << 30 if r == "split" else 0
            tiles.SPLIT_MIN_WORDS["partition_gain"] = 0 if r == "split" else 1 << 30
            _exact_gains_one(problem, cons, x, st.covered_d, js[0])
            torch.cuda.synchronize()
            t = time.perf_counter()
            for j in js:
                _exact_gains_one(problem, cons, x, st.covered_d, j)
            out[r]["eval_ms"].append((time.perf_counter() - t) * 1e3 / len(js))
            lz = part_lazy(p3, cons)
            out[r]["lazy_ms_a_selection"].append(lz["ms_a_selection"])
            out[r]["lazy_order"] = lz["order"]
            out[r]["lazy_launches"] = lz["launches"]
    finally:
        for d, old in zip((tiles.SPLIT_MAX_TASKS, tiles.SPLIT_MIN_WORDS), saved):
            d.clear()
            d.update(old)
    return out


def part_offer(p3, st, js) -> dict:
    from repro_torch.core.constraint import GlobalBudget
    problem = p3["problem"]
    cons = GlobalBudget(p3["budget"])
    weights = problem.query_weights

    def offer(j):
        fg = float(problem.f_gains(st.covered_q, rows=problem.clause_query_bits[j:j + 1],
                                   weights=weights)[0])
        _, g_part = cons.gains(problem, st.covered_d, rows=problem.clause_doc_bits[j:j + 1])
        feasible = bool(cons.feasible(cons.used(problem, st), g_part)[0])
        return fg / max(float(g_part.sum()), 1.0), feasible

    offer(js[0])
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for j in js:
            offer(j)
        passes.append((time.perf_counter() - t) * 1e3 / len(js))
    return dict(ms_an_offer=statistics.median(passes), passes=passes)


def part_lazy(p3, cons=None) -> dict:
    """Two lazy selections from the empty state, under the global budget or
    the constraint `cons`."""
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.kernels import _build
    problem = p3["problem"]
    budget = p3["budget"] if cons is None else cons.total
    _build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = registry.solve(problem, SolveConfig(budget=budget, solver="lazy",
                                              constraint=cons, max_steps=2))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    evals = (res.n_exact_evals - 2 * problem.n_clauses) // 2
    return dict(selections=len(res.order), s=dt, order=list(res.order),
                ms_a_selection=dt * 1e3 / max(1, len(res.order)),
                exact_evals=evals, ms_an_eval=dt * 1e3 / max(1, evals),
                launches={k: v for k, v in _build.LAUNCHES.items() if v})


def part_sweep(p3, st, x) -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.bit_matvec import bit_matvec
    from repro_torch.kernels.coverage_gain import coverage_gain
    problem = p3["problem"]
    aq, ad = problem.clause_query_bits, problem.clause_doc_bits
    out: dict = {"sweep": []}
    cs = [1 << k for k in range(13)]
    widths = [aq.shape[1], MEDIUM_WIDTHS["bit_matvec"], MEDIUM_WIDTHS["coverage_gain"],
              *SWEEP_WIDTHS]
    perm = torch.randperm(aq.shape[0], generator=torch.Generator().manual_seed(1)).to(aq.device)
    cases = [(k, w, "first") for w in widths for k in ("bit_matvec", "coverage_gain")]
    cases += [("bit_matvec", w, "random") for w in widths]
    for name, w, rows in cases:
        for c in cs:
            idx = perm[:c] if rows == "random" else torch.arange(c, device=aq.device)
            if name == "bit_matvec":
                a = aq[idx, :w].contiguous()
                xs = x[:w * 32, None].contiguous()
                fns = {r: [lambda r=r: bit_matvec(a, xs, route=r)] * 20 for r in ("warp", "split")}
            else:
                a = ad[:c, :w].contiguous()
                m = st.covered_d[:w].contiguous()
                fns = {r: [lambda r=r: coverage_gain(a, m, route=r)] * 20 for r in ("warp", "split")}
            t = {"warp": [], "split": []}
            for r in ("warp", "split", "split", "warp"):
                t[r].append(graph_ms(fns[r]))
            warp, split = statistics.fmean(t["warp"]), statistics.fmean(t["split"])
            out["sweep"].append(dict(kernel=name, c=c, w=w, rows=rows, warp_ms=warp,
                                     split_ms=split,
                                     warp_runs=t["warp"], split_runs=t["split"],
                                     bound_ms=4 * c * w / HBM * 1e3))
            print(f"[sweep] {name} C={c} W={w} {rows} rows: warp {warp:.4f} split {split:.4f} ms",
                  flush=True)
    # the split route's cluster size at C = 1, through the C entries directly
    lib = _build.lib()
    dev = aq.device
    j = 0
    res = torch.empty(1, dtype=torch.float32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    xs = x[:, None].contiguous()
    sizes = {}
    for ctas in (1, 2, 4, 8, 16):
        for warps in (4, 8, 16):
            bm = [lambda: _build._call("bit_matvec", dev, lambda l, s: l.bit_matvec_split_launch(
                aq[j].data_ptr(), xs.data_ptr(), res.data_ptr(), 1, aq.shape[1], 1, ctas,
                warps, s))] * 20
            cg = [lambda: _build._call("coverage_gain", dev, lambda l, s: l.coverage_gain_split_launch(
                ad[j].data_ptr(), st.covered_d.data_ptr(), cnt.data_ptr(), 1, ad.shape[1], ctas,
                warps, s))] * 20
            sizes[f"ctas{ctas}_warps{warps}"] = dict(bit_matvec_ms=graph_ms(bm),
                                                     coverage_gain_ms=graph_ms(cg))
    del lib
    out["cluster_sizes_c1"] = sizes
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("one_row_probe: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    card = chip_smoke.card_line()
    p3 = chip_smoke.phase3(args.seed, {})
    problem = p3["problem"]
    st = problem.state_for(p3["greedy"].order[:args.prefix])
    x = problem.uncovered_weights(st.covered_q)
    gen = torch.Generator().manual_seed(args.seed)
    js = torch.randperm(problem.n_clauses, generator=gen)[:64].tolist()
    parts = args.parts.split(",")
    res = {"tag": args.tag, "root": str(root), "card": card}
    cons = shard_caps(p3, chip_smoke.N_PARTS)

    def put(key, value):
        res[key] = value
        print(json.dumps({key: value}), flush=True)

    # the host-bound paths first, before any graph capture or profiler
    if "offer" in parts:
        put("offer", part_offer(p3, st, js))
    if "lazy" in parts:
        put("lazy", part_lazy(p3))
        put("lazy_shard", part_lazy(p3, cons))
    from repro_torch.kernels.coverage_gain import coverage_gain
    from repro_torch.kernels.partition_gain import partition_gain
    if "ab" in parts and routes_of(coverage_gain) != [None]:
        put("ab", part_ab(p3, st, js, x))
    if "ab" in parts and routes_of(partition_gain) != [None]:
        put("ab_shard", part_ab_shard(p3, st, js, x, cons))
    if "eval" in parts:
        put("eval", part_eval(p3, st, js, x))
        put("eval_shard", part_eval_shard(p3, st, js, x, cons))
    if "launch" in parts:
        put("launch", part_launch(p3, st, js, x))
        put("launch_shard", part_launch_shard(p3, st, js, x, cons))
    if "sweep" in parts and routes_of(coverage_gain) != [None]:
        res["sweep"] = part_sweep(p3, st, x)
        print(json.dumps({"cluster_sizes_c1": res["sweep"]["cluster_sizes_c1"]}), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"one_row_probe_{args.tag}.json").write_text(json.dumps(res, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
