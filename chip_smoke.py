"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failure is an uncaught exception and
a non-zero exit):
  0. environment: card name and power limit, torch/CUDA versions, and the
     build of the nine CUDA kernels from `src/repro_torch/kernels/csrc`
     (ptxas registers and spills of each).
  1. each kernel against its plain PyTorch version on ragged small shapes
     (exact for the integer kernels, allclose for bit_matvec);
     partition_gain also against coverage_gain, sparse_gain on masks on
     both sides of its shared-memory limit; clause_match on empty
     clauses, clauses of 4 and of 5+ tokens (its compact table's
     overflow), bit 31 of the last word, K 1, K 5000, ragged B, Wv 20000
     and the vocab-word limit, B up to 9000 (1 to 32 queries a block),
     aligned and not, its compact table also against `ref.clause_tokens`.
  2. at the `medium` preset, on the card and then on the CPU (plain
     versions), through the normal entry points:
     a. the main path: mine -> greedy/optpes -> verify/coverage -> deploy +
        serve 2000 requests (each batch == serve_reference) -> warm-started
        sweep;
     b. per-shard budgets: greedy/optpes with budget_split="traffic" over 4
        shards, a partitioned sweep, a warm refit onto the test weights;
        then the sparse greedy round over padded doc-id lists against the
        dense greedy step on the same problem.
     c. the paper's other solvers through `pipe.solve`: lazy (Alg. 1),
        agnostic (§5.1), isk1/isk2 (Alg. 3; 3 outer iterations of at most
        64), stochastic (§3.2, m = 2048), flow-popularity, flow-max and
        flow-sgd (§2.3), lazy under the 4-shard traffic caps, and
        `build_multitier` at 3 budgets (§6), each cut to 128 selections,
        each path's launches counted from 0; lazy == greedy's prefix up to
        an f32 tie (globally and under the caps) with fewer exact
        evaluations, greedy >= agnostic, ISK within B, the multi-tier
        system nested and exact (`verify_multitier`).
     Orders, selections, caps, fills, match sets and ServeStats must agree
     between the two devices; flow-sgd's logits within 1e-3 (rtol) and
     1e-4 (atol), its Tier-1 docs equal but at the budget's boundary.
  3. the production shapes (configs/tiering_scsk.py: 2^17 vocabulary, 2^20
     queries, 4096-query serve batches), cut to 2^16 clauses and 2^20 docs
     so that every operand is resident on one 80 GB card:
     a. greedy == optpes (up to exact ties), serve == serve_reference on two
        batches;
     b. greedy and optpes under 8 per-shard caps set to half of the global
        greedy's fills (the caps bind): equal orders, every fill <= cap;
     c. the sparse round over the clauses with |m(c)| <= 4096 against dense
        greedy over the same rows: equal orders and covered docs;
     d. lazy (stopped at 30 s), agnostic, stochastic (m = 2048), isk1 and
        isk2 (3 x at most 128), 128 selections each: time per selection
        (ISK: per outer iteration), exact evaluations and launches beside
        greedy's; one exact evaluation timed alone; lazy == greedy's prefix
        up to f32 ties;
     e. the telemetry plane: the kernel profiler's measured rows for one
        greedy step and one serve batch (each at most 1.05 of the H100's
        3.35 TB/s), `kernel_words_scanned_total` equal to the ops' word
        models, a greedy solve and a serve batch bit-identical with the
        plane off.
     Launch counts are read from each path's own run. The kernel timings
     below run with the telemetry plane off, as they did before it existed. Then each kernel
     against its plain version at these shapes, with its timing and bound;
     clause_match also at serve_route's K: the serve batch against the
     deployment's 2^16 candidate clauses, in the vocabulary's order and
     permuted (identical answers), with ops.fused_match's time there; and
     sparse_gain once more at solve_sparse_xl's own shapes (2^20 lists of
     4096 ids over 2^28 docs, the L2 route), then with the ids folded into
     2^24 docs.
  4. the LM serving path, once the tiering operands are freed. Attention
     has three kernels, routed by the operands: the wgmma kernel
     (flash_prefill) for Sq > 1 in bf16 with D in (64, 128, 256) and
     16-byte aligned operands, the tile kernel (flash_attention) for every
     other Sq > 1 call (f32 among them), the split-KV kernel (flash_decode)
     for one query position.
     a. flash_attention against its plain version on ragged shapes (f32 on
        the tile kernel, bf16 on flash_prefill where it takes the shape,
        rows that see no key, kv_len 0, keys past kv_len poisoned with NaN);
        flash_decode on ragged decode shapes (every head dim, G
        1-16, 0 to 5000 keys, B*Hkv 1-140 so the plan runs from 1 split to
        its most, 8-byte bf16 rows, no visible key); then both at gemma2-2b's
        shapes: prefill at S = 8192 and 32768 (the plain version on
        512-query blocks there), decode against a strided slice of a
        32768-position cache (bf16 prefill on flash_prefill, its f32 copies
        on the tile kernel); timed at the model's four settings beside one
        compiled flex_attention call (softcap as its score_mod, causal +
        window as its block mask), and beside one SDPA call in the setting
        where SDPA computes the same function (no softcap, no window); the
        tile kernel timed at the prefill settings on the f32 copies, its
        route; the decode settings' device time also from a torch.profiler
        trace;
     b. gemma2-2b at full width and depth (26 layers), parameters made on
        the card from --seed: decode_step == forward over a 64-token prompt
        (f32 and bf16), card == CPU at 2 layers over 256 tokens, then
        prefill B=1 x 32768 and decode steps at B=8 against a 32768-position
        cache (28 GB), each run's launches counted: prefill on flash_prefill
        alone, decode on flash_decode alone, the f32 forward of
        decode_step == forward on the tile kernel; then one
        prefill and two decode steps under torch.profiler for the device's
        busy time.
  5. streaming re-tiering and the sharded fleet (host path), after the
     production kernel timings of phase 1 and before phase 4, each path's
     launches counted from 0:
     a. `medium`, on the card and then on the CPU: greedy (64 selections)
        under the re-tiering loop (`RetieringController`, rotate, 8 windows
        of 512 queries, a Theorem 3.1 check after every swap), then a
        traffic-split greedy on a 4-shard fleet (2 Tier-1 replicas, the
        result cache) under the same loop. Every WindowReport field but
        refit_seconds, the cumulative stats, each refit's order, the fleet's
        stats, BatchTraces and cache must be equal on both devices; the
        retiered engine must beat a static run on the same windows;
     b. the production shapes: the loop over phase 3's problem, engine and
        greedy state (rotate, 6 windows of 4096 queries; each refit a
        prune_state, a warm greedy of at most 128 selections and a swap,
        timed by part); after each swap the whole window == serve_reference;
        the controller's eligibility over the 2^20 queries (clause_match)
        == classify_queries on a 4096-query sample;
     c. phase 3's clause bitsets and Tier-1 copy freed, an 8-shard fleet (1
        replica per tier) over phase 3's postings: a batch at the greedy
        tiering, a rolling swap to 5b's last tiering with a batch per phase,
        a batch at the new generation, each == the single-tier oracle, every
        BatchTrace consistent;
     d. `python -m repro_torch.launch.stream --scale small --windows 12
        --verify` and `python -m repro_torch.launch.cluster --scale small
        --shards 4 --replicas 2 --budget-split traffic --cache --verify` as
        subprocesses on the card, started with 5a; each must exit 0.
The last lines are the kernels' JSON record, the card line, and the
contract line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM FP64 outside the tensor cores (ditto)

# production shapes (configs/tiering_scsk.py) and the cuts one card forces
VOCAB = 2 ** 17                # serve_route vocabulary -> Wv = 4096
N_QUERIES = 2 ** 20            # solve_dense_m queries -> Wq = 32768
N_CLAUSES = 2 ** 16            # cut from solve_dense_m's 2^17
N_DOCS = 2 ** 20               # cut from 2^22..2^23 -> Wd = 32768
SERVE_B, SERVE_L = 4096, 8     # serve_route batch
REFRESH_K = 4096               # tiering_scsk refresh_k
N_PARTS = 8                    # per-shard caps at the production shapes
SPARSE_M = 4096                # solve_sparse_xl's padded list length
XL_CLAUSES, XL_DOCS = 2 ** 20, 2 ** 28   # solve_sparse_xl, uncut
XL_FOLD_DOCS = 2 ** 24         # the folded run's reach: a 2 MiB slice of the mask
MAIN_KERNELS = ("coverage_gain", "bit_matvec", "clause_match", "tier_match")
REDUCED = {
    "clauses": "2^16 token singletons and pairs (solve_dense_m has 2^17)",
    "docs": "2^20 (solve_dense_m 2^23, serve_route 2^22; 2^20 is the low "
            "end of the paper's |D| range)",
    "solve_steps": "max_steps=128 per solver and per sparse round",
    "sparse_round": "the phase-3 clauses with |m(c)| <= 4096 (the rest get "
                    "an all -1 list and start selected)",
    "isk": "3 outer iterations of at most 128 inner selections (medium: "
           "at most 64, every other medium solver its first 128 selections)",
    "lazy": "stops at 30 s of wall clock (max_steps=128)",
    "stream": "phase 5b: 6 rotate windows of 4096 queries, refits of at most "
              "128 selections, 3 windows apart; 5a (medium): 8 windows of "
              "512, solves and refits of at most 64 selections, 2 windows "
              "apart (128 every window took 105 s on 8 CPU cores)",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn()` over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of `fn()` per call: `reps` calls captured in one CUDA
    graph, replayed once between two CUDA events. The wrappers' host work
    drops out; it sets the event time of a call shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1: kernels against their plain versions on ragged small shapes ------

def rand_words(gen, shape, device) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device=device, generator=gen)


def sparse_words(gen, shape, p, device) -> torch.Tensor:
    from repro_torch.core import bitset
    bits = torch.rand(shape[:-1] + (shape[-1] * 32,), generator=gen,
                      device=device) < p
    return bitset.pack(bits)


def pick_bits(gen, pool: torch.Tensor, n: int, nbits: int) -> torch.Tensor:
    """A bool row of `nbits` with `n` random positions of `pool` set."""
    row = torch.zeros(nbits, dtype=torch.bool, device=pool.device)
    row[pool[torch.randperm(len(pool), generator=gen, device=pool.device)[:n]]] = True
    return row


def edge_clauses(gen, q: torch.Tensor, empty: bool = False) -> torch.Tensor:
    """Clause rows over q's words: 1-3, exactly 4, 5 and 9 set bits (the
    last two overflow the compact table), every other one drawn from a
    random query's bits (so it matches); bit 31 of the last word alone; a
    dense row; and with `empty` an empty row (which matches every query)."""
    from repro_torch.core import bitset
    (b, wv), dev = q.shape, q.device
    nbits = wv * 32
    qb = bitset.unpack(q)
    rows = []
    for i, n in enumerate((1, 1, 2, 3, 4, 4, 5, 5, 9, 9)):
        pick = int(torch.randint(b, (1,), generator=gen, device=dev))
        pool = (torch.nonzero(qb[pick])[:, 0] if i % 2
                else torch.arange(nbits, device=dev))
        rows.append(pick_bits(gen, pool, n, nbits))
    top = torch.zeros(nbits, dtype=torch.bool, device=dev)
    top[-1] = True
    rows += [top, torch.rand(nbits, generator=gen, device=dev) < 0.5]
    if empty:
        rows.append(torch.zeros(nbits, dtype=torch.bool, device=dev))
    return bitset.pack(torch.stack(rows))


def clause_cases(gen, device):
    """(name, queries, clauses) for clause_match's ragged checks."""
    from repro_torch.core import bitset
    from repro_torch.kernels.clause_match import MAX_VOCAB_WORDS
    for b, k, wv in [(1, 1, 1), (7, 3, 2), (65, 17, 3), (130, 70, 5),
                     (16, 1, 9), (33, 5, 4096), (9, 4, 20000),
                     (300, 64, MAX_VOCAB_WORDS)]:
        q = rand_words(gen, (b, wv), device)
        cl = sparse_words(gen, (k, wv), 2.0 / (wv * 32), device)
        cl[: k // 2] &= q[: k // 2]                  # some clauses match
        yield "sparse", q, cl
    for name, b, wv in [("edges", 37, 3), ("ragged B", 133, 5),
                        ("edges, Wv 20000", 67, 20000),
                        ("edges at the vocab-word limit", 3, MAX_VOCAB_WORDS),
                        ("edges, B 9000", 9000, 3)]:
        q = sparse_words(gen, (b, wv), 0.35, device)
        yield name, q, edge_clauses(gen, q)
    q = sparse_words(gen, (21, 3), 0.35, device)
    yield "empty clause", q, edge_clauses(gen, q, empty=True)
    q = sparse_words(gen, (33, 2), 0.35, device)
    on = torch.nonzero(bitset.unpack(q[5]))[:, 0]
    yield "K 1", q, bitset.pack(pick_bits(gen, on, 3, 64)[None])
    # K 5000 at Wv 2: every clause but the last 40 holds token 63, which no
    # query holds; the last 40 are 2..9 tokens of queries 0..39. At B 1000
    # pass B takes 3 queries a block, at B 9000 (edges above) its most, 32;
    # both end on a part-filled block.
    for b in (70, 1000):
        q = sparse_words(gen, (b, 2), 0.3, device)
        q[:, 1] &= 0x7FFFFFFF
        cl = sparse_words(gen, (5000, 2), 0.05, device)
        cl[:, 1] |= -2 ** 31
        qb = bitset.unpack(q[:40])
        cl[-40:] = bitset.pack(torch.stack([
            pick_bits(gen, torch.nonzero(qb[i])[:, 0], 2 + i % 8, 64)
            for i in range(40)]))
        yield f"K 5000, B {b}", q, cl


def phase1_small(device) -> float:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.clause_match import clause_tokens
    gen = torch.Generator(device).manual_seed(11)
    worst = 0.0                                  # bit_matvec max abs error

    def misaligned(t):      # same values, data pointer 4 bytes past 16
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    for c, w in [(1, 1), (3, 2), (13, 3), (130, 5), (64, 33), (300, 17),
                 (257, 1024), (1000, 4)]:
        a = rand_words(gen, (c, w), device)
        a[0] = -1                                    # an all-ones row (bit 31 set)
        mask = rand_words(gen, (w,), device)
        for aa in (a, misaligned(a)):
            got = ops.coverage_gain(aa, mask)
            check(torch.equal(got, ref.coverage_gain(aa, mask)),
                  f"coverage_gain {c}x{w}")
        for r in (1, 3):
            x = torch.rand((w * 32, r), generator=gen, device=device)
            want = ref.bit_matvec(a, x)
            for aa in (a, misaligned(a)):
                got = ops.bit_matvec(aa, x)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
                worst = max(worst, float((got - want).abs().max()))

    for name, q, cl in clause_cases(gen, device):
        for qq, cc in ((q, cl), (misaligned(q), misaligned(cl))):
            got = ops.clause_match(qq, cc)
            check(torch.equal(got, ref.clause_match(qq, cc)),
                  f"clause_match {name} {tuple(q.shape)} x {cl.shape[0]}")
            tokens, count = clause_tokens(cc)
            want_t, want_c = ref.clause_tokens(cc)
            check(torch.equal(tokens, want_t) and torch.equal(count, want_c),
                  f"clause_match's compact table {name} {tuple(cl.shape)}")
    q = rand_words(gen, (5, 2), device)
    empty = torch.zeros((0, 2), dtype=torch.int32, device=device)
    check(not ops.clause_match(q, empty).any(), "clause_match K=0")
    check(ops.clause_match(empty, q).shape == (0,), "clause_match B=0")

    for b, ell, v, w in [(19, 4, 37, 5), (64, 8, 100, 8), (7, 1, 3, 1),
                         (300, 3, 50, 33), (0, 2, 4, 4)]:
        t1 = rand_words(gen, (v, w), device)
        t2 = t1 | rand_words(gen, (v, w), device)
        toks = torch.randint(-1, v, (b, ell), dtype=torch.int32, device=device,
                             generator=gen)
        if b:
            toks[0] = -1                             # a query with no token
        sel = torch.rand(b, generator=gen, device=device) < 0.5
        for s in (None, sel):
            got = ops.tier_match(t1, t2, s, toks)
            check(torch.equal(got, ref.tier_match(t1, t2, s, toks)),
                  f"tier_match {b}x{ell} over [{v}, {w}]")

    # partition_gain: the reference test's four cases, then offsets that are
    # not multiples of 4 words (11 words in 3 parts: 0, 4, 8, 11), one word
    # per part, and P = W
    from repro_torch.core.constraint import partition_bounds
    for c, w, parts in [(37, 11, 3), (5, 3, 1), (130, 33, 5), (64, 8, 8),
                        (300, 17, 17), (257, 1024, 8), (1000, 4, 3),
                        (66, 64, 7)]:
        bounds = partition_bounds(w * 32, parts)
        a = rand_words(gen, (c, w), device)
        a[0] = -1
        mask = rand_words(gen, (w,), device)
        for aa in (a, misaligned(a)):
            for mm in (mask, misaligned(mask)):
                got = ops.partition_gain(aa, mm, bounds)
                check(torch.equal(got, ref.partition_gain(aa, mm, bounds)),
                      f"partition_gain {c}x{w} over {bounds}")
                check(torch.equal(got.sum(-1, dtype=torch.int32),
                                  ops.coverage_gain(aa, mm)),
                      f"partition_gain {c}x{w} does not sum to coverage_gain")

    # sparse_gain: -1 at random places; masks on both sides of the
    # shared-memory limit (58112 words is the largest that is staged)
    from repro_torch.kernels.sparse_gain import SMEM_BYTES, smem_route
    limit = SMEM_BYTES // 4
    for c, m, w in [(1, 4, 2), (5, 7, 4), (33, 40, 64), (128, 65, 16),
                    (300, 1, 1), (64, 4096, 32768), (97, 333, limit),
                    (97, 333, limit + 1), (40, 1024, 2 ** 20)]:
        ids = torch.randint(0, w * 32, (c, m), dtype=torch.int32,
                            device=device, generator=gen)
        ids[torch.rand((c, m), generator=gen, device=device) < 0.3] = -1
        ids[0] = -1                                  # a row of padding only
        mask = rand_words(gen, (w,), device)
        for ii in (ids, misaligned(ids)):
            got = ops.sparse_gain(ii, mask)
            check(torch.equal(got, ref.sparse_gain(ii, mask)),
                  f"sparse_gain {c}x{m} over {w} words "
                  f"({'smem' if smem_route(w) else 'l2'} route)")
    check(smem_route(limit) and not smem_route(limit + 1),
          "the shared-memory limit is not where phase 1 tests it")
    torch.cuda.synchronize()
    return worst


# -- phase 2: the main path through the normal entry points (medium) ----------

def run_pipeline(pipe, n_requests: int = 2000, batch: int = 128) -> dict:
    """The quickstart / launch.serve sequence on a mined pipeline."""
    out: dict = {}
    t = time.perf_counter()
    for solver in ("greedy", "optpes"):
        pipe.solve(solver, budget_frac=0.5)
        out[solver] = pipe.result
    out["solve_s"] = time.perf_counter() - t
    out["div"] = first_divergence(pipe.problem, out["greedy"].order,
                                  out["optpes"].order)
    check(pipe.verify(), "Theorem 3.1 violated")
    out["coverage"] = pipe.coverage()
    engine = pipe.deploy()
    lg = pipe.log
    rng = np.random.default_rng(1)
    probs = lg.test_weights / lg.test_weights.sum()
    served, matches = 0, []
    t = time.perf_counter()
    while served < n_requests:
        n = min(batch, n_requests - served)
        qs = [lg.queries[i] for i in rng.choice(lg.n_queries, size=n, p=probs)]
        got = engine.serve(qs)
        ref = engine.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "serve != serve_reference")
        matches.extend(got)
        served += n
    out["serve_s"] = time.perf_counter() - t
    out["matches"] = matches
    out["stats"] = engine.stats.to_dict()
    n = pipe.corpus.n_docs
    t = time.perf_counter()
    out["sweep"] = pipe.sweep([n // 4, n // 2], "greedy")
    out["sweep_s"] = time.perf_counter() - t
    return out


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def ordered_or_tied(problem, a: list[int], b: list[int], what: str) -> None:
    """Two solvers' orders are equal, or first differ at an exact f/g tie."""
    div = first_divergence(problem, a, b)
    check(div is None or div[1], f"{what}: orders differ at {div} without a tie")


def sparse_round(problem, ids, state, budget: float, steps: int) -> dict:
    """`sparse_greedy_step` over the -1-padded `ids` against the dense
    `greedy_step` on the same problem, from the same `state`, step for step,
    until both stop or `steps` selections: same clause, same stop, same
    covered docs."""
    from repro_torch.core.greedy import greedy_step
    from repro_torch.core.sparse_step import sparse_greedy_step
    sp = (state.covered_q, state.covered_d, state.selected, state.g_used)
    order = []
    stop = False
    t_sparse = t_dense = 0.0
    for _ in range(steps):
        t = time.perf_counter()
        *sp, j, stop = sparse_greedy_step(
            ids, problem.clause_query_bits, problem.query_weights, *sp, budget)
        t_sparse += time.perf_counter() - t
        t = time.perf_counter()
        state, jd, dstop = greedy_step(problem, state, budget)
        t_dense += time.perf_counter() - t
        check((j, stop) == (jd, dstop),
              f"sparse round picked ({j}, {stop}), dense ({jd}, {dstop}) "
              f"at step {len(order)}")
        if stop:
            break
        order.append(j)
    check(torch.equal(sp[1], state.covered_d), "sparse round covered_d != dense")
    check(float(sp[3]) == float(state.g_used), "sparse round g_used != dense")
    return dict(order=order, stop=stop, covered_d=sp[1], g_used=float(sp[3]),
                sparse_s=t_sparse, dense_s=t_dense)


def run_partitioned(pipe, n_shards: int = 4, steps: int = 128) -> dict:
    """Per-shard budgets through the pipeline (traffic split over
    `n_shards`), a partitioned sweep, a warm refit onto the test weights,
    then the sparse greedy round on the same problem."""
    from repro_torch.core import constraint as tc
    from repro_torch.data import incidence
    out: dict = {}
    split = dict(budget_split="traffic", n_shards=n_shards)
    t = time.perf_counter()
    for solver in ("greedy", "optpes"):
        r = pipe.solve(solver, budget_frac=0.5, **split).result
        check(np.all(r.extra["g_part"] <= r.extra["caps"]),
              f"partitioned {solver} overfills a shard: {r.extra}")
        out[solver] = r
    ordered_or_tied(pipe.problem, out["greedy"].order, out["optpes"].order,
                    "partitioned greedy vs optpes (medium)")
    check(pipe.verify(), "Theorem 3.1 violated under per-shard budgets")
    out["solve_s"] = time.perf_counter() - t
    n = pipe.corpus.n_docs
    t = time.perf_counter()
    out["sweep"] = pipe.sweep([n // 4, n // 2], "greedy", **split)
    for r in out["sweep"]:
        check(np.all(r.extra["g_part"] <= r.extra["caps"]),
              "partitioned sweep overfills a shard")
    out["sweep_s"] = time.perf_counter() - t

    # warm refit onto the test weights: the traffic split is re-allocated
    # and the warm state trimmed of clauses touching over-cap shards
    prev = pipe.solve("greedy", budget_frac=0.5, **split).result
    test_w = pipe.log.test_weights
    new = pipe.partition_constraint(float(int(n * 0.5)), "traffic", n_shards,
                                    weights=np.asarray(test_w, np.float64))
    _, dropped = tc.trim_state(pipe.problem.with_weights(test_w), prev.state,
                               new)
    t = time.perf_counter()
    r = pipe.refit(test_w, state=prev.state).result
    out["refit_s"] = time.perf_counter() - t
    check(np.array_equal(r.extra["caps"], new.caps.astype(np.float64)),
          "refit did not re-allocate the caps from the new weights")
    check(np.all(r.extra["g_part"] <= r.extra["caps"]), "refit overfills a shard")
    out["refit"], out["refit_prev_caps"] = r, prev.extra["caps"]
    out["refit_dropped"] = dropped.tolist()

    # the sparse round: the same clauses as -1-padded sorted doc-id lists
    ids = torch.from_numpy(incidence.padded_id_lists(
        pipe.data.clause_doc_bits, n)).to(pipe.device)
    problem = pipe.problem
    out["sparse"] = sparse_round(problem, ids, problem.init_state(),
                                 float(int(n * 0.5)), steps)
    out["sparse_m"] = ids.shape[1]
    return out


def compare_partitioned(gpu: dict, cpu: dict) -> None:
    """The per-shard-budget path gave the same results on both devices."""
    for key in ("greedy", "optpes", "refit"):
        g, c = gpu[key], cpu[key]
        check(g.order == c.order, f"partitioned {key} order differs from the CPU run")
        for e in ("caps", "g_part"):
            check(np.array_equal(g.extra[e], c.extra[e]),
                  f"partitioned {key} {e} differs from the CPU run")
    for g, c in zip(gpu["sweep"], cpu["sweep"]):
        check(g.order == c.order and np.array_equal(g.extra["caps"], c.extra["caps"])
              and np.array_equal(g.extra["g_part"], c.extra["g_part"]),
              "partitioned sweep differs from the CPU run")
    check(gpu["refit_dropped"] == cpu["refit_dropped"], "refit trimmed differently")
    gs, cs = gpu["sparse"], cpu["sparse"]
    check(gs["order"] == cs["order"] and gs["stop"] == cs["stop"]
          and torch.equal(gs["covered_d"].cpu(), cs["covered_d"]),
          "sparse round differs from the CPU run")
    g = gpu
    log(f"[phase 2] per-shard budgets (4 shards, traffic split): greedy "
        f"{len(g['greedy'].order)} / optpes {len(g['optpes'].order)} "
        f"selections, caps {g['greedy'].extra['caps'].tolist()} fills "
        f"{g['greedy'].extra['g_part'].tolist()}; sweep orders "
        f"{[len(r.order) for r in g['sweep']]}; refit caps "
        f"{g['refit_prev_caps'].tolist()} -> {g['refit'].extra['caps'].tolist()}"
        f", {len(g['refit_dropped'])} warm clauses trimmed, "
        f"{len(g['refit'].order)} new selections")
    log(f"[phase 2] sparse round (M={g['sparse_m']}): {len(gs['order'])} "
        f"selections (stop {gs['stop']}), g={gs['g_used']:.0f}, == dense greedy")
    log(f"[phase 2] per-shard path cuda: solve {g['solve_s']:.2f}s sweep "
        f"{g['sweep_s']:.2f}s refit {g['refit_s']:.2f}s sparse round "
        f"{gs['sparse_s']:.2f}s (dense {gs['dense_s']:.2f}s) | cpu: solve "
        f"{cpu['solve_s']:.2f}s sweep {cpu['sweep_s']:.2f}s refit "
        f"{cpu['refit_s']:.2f}s sparse round {cs['sparse_s']:.2f}s "
        f"(dense {cs['dense_s']:.2f}s)")


# the paper's other solvers and options at `medium`, cut to the first 128
# selections (ISK: 3 outer iterations of at most 64); both devices run the
# same cuts, which keep the CPU half of phase 2c near two minutes
MEDIUM_STEPS = 128
MEDIUM_SOLVERS = (("lazy", {}), ("agnostic", {}),
                  ("isk1", {"max_outer": 3, "max_inner": 64}),
                  ("isk2", {"max_outer": 3, "max_inner": 64}),
                  ("stochastic", {"batch_queries": 2048}),
                  ("flow-popularity", {}), ("flow-max", {}), ("flow-sgd", {}))
SGD_RTOL, SGD_ATOL = 1e-3, 1e-4   # flow-sgd logits after 300 float32 steps


def run_solvers(pipe, n_shards: int = 4) -> dict:
    """Every other registered solver through the pipeline, then lazy under
    the traffic-split per-shard caps, then a 3-budget multi-tier system.
    Each path's kernel launches are counted from 0 over its own run."""
    from repro_torch.core import multitier
    from repro_torch.kernels import _build
    out: dict = {"launches": {}, "seconds": {}}

    def run(key, fn):
        _build.reset_launches()
        t = time.perf_counter()
        out[key] = fn()
        out["seconds"][key] = time.perf_counter() - t
        out["launches"][key] = {k: v for k, v in _build.LAUNCHES.items() if v}

    for name, opts in MEDIUM_SOLVERS:
        run(name, lambda: pipe.solve(name, budget_frac=0.5,
                                     max_steps=MEDIUM_STEPS, **opts).result)
    run("lazy-caps", lambda: pipe.solve(
        "lazy", budget_frac=0.5, budget_split="traffic", n_shards=n_shards,
        max_steps=MEDIUM_STEPS).result)
    n = pipe.corpus.n_docs
    run("multitier", lambda: multitier.build_multitier(
        pipe.data, [n // 32, n // 16, n // 8], solver="greedy",
        device=pipe.device, max_steps=MEDIUM_STEPS))
    mt = out["multitier"]
    out["multitier_ok"] = multitier.verify_multitier(mt, pipe.data)
    out["routes"] = mt.route(pipe.data.log.query_bits)
    return out


def compare_solvers(gpu: dict, cpu: dict, main: dict, part: dict,
                    problem, budget: float) -> None:
    """The card's runs of the other solvers against the CPU's, and against
    the paper's claims: lazy == greedy up to an f32 tie (globally and under
    the caps) with fewer exact evaluations, greedy >= agnostic, ISK within
    its budget, the multi-tier system nested and exact."""
    scsk = [n for n, _ in MEDIUM_SOLVERS if not n.startswith("flow")]
    for key in scsk + ["lazy-caps"]:
        g, c = gpu[key], cpu[key]
        check(g.order == c.order, f"{key} order differs from the CPU run")
        check(np.array_equal(g.selected, c.selected), f"{key} selection differs")
        check(g.g_final == c.g_final and g.n_exact_evals == c.n_exact_evals,
              f"{key} g_final / n_exact_evals differ from the CPU run")
        check(math.isclose(g.f_final, c.f_final, rel_tol=1e-5),
              f"{key} f_final {g.f_final} vs {c.f_final}")
    np.testing.assert_array_equal(gpu["lazy-caps"].extra["g_part"],
                                  cpu["lazy-caps"].extra["g_part"])
    check(np.all(gpu["lazy-caps"].extra["g_part"]
                 <= gpu["lazy-caps"].extra["caps"]), "lazy overfills a shard")
    lazy, lazy_caps = gpu["lazy"].order, gpu["lazy-caps"].order
    ordered_or_tied(problem, lazy, main["greedy"].order[:len(lazy)],
                    "lazy vs greedy (medium)")
    check(np.array_equal(gpu["lazy-caps"].extra["caps"],
                         part["greedy"].extra["caps"]), "caps differ")
    ordered_or_tied(problem, lazy_caps, part["greedy"].order[:len(lazy_caps)],
                    "lazy vs greedy under the caps (medium)")
    # greedy evaluates every clause twice per selection
    greedy_evals = 2 * problem.n_clauses * len(lazy)
    check(gpu["lazy"].n_exact_evals < greedy_evals,
          "lazy made no fewer exact evaluations than greedy")
    check(main["greedy"].f_final >= gpu["agnostic"].f_final,
          "agnostic beat greedy")
    for key in ("isk1", "isk2"):
        check(np.all(gpu[key].g_history <= budget),
              f"{key} history exceeds the budget")
    check(gpu["multitier_ok"] and cpu["multitier_ok"],
          "verify_multitier failed")
    check(np.array_equal(gpu["routes"], cpu["routes"]) and all(
        np.array_equal(a, b) for a, b in zip(gpu["multitier"].tier_docs,
                                             cpu["multitier"].tier_docs)),
        "multi-tier routes or tiers differ from the CPU run")
    for key in ("flow-popularity", "flow-max"):
        g, c = gpu[key].extra, cpu[key].extra
        check(all(np.array_equal(g[k], c[k])
                  for k in ("tier1_docs", "eligible_queries")),
              f"{key} differs from the CPU run")
    g, c = gpu["flow-sgd"].extra, cpu["flow-sgd"].extra
    theta, want = g["flow"].doc_scores, c["flow"].doc_scores
    check(np.allclose(theta, want, rtol=SGD_RTOL, atol=SGD_ATOL),
          f"flow-sgd logits differ: max abs {np.abs(theta - want).max()}")
    b = int(g["tier1_docs"].sum())
    cut = np.sort(theta)[::-1][b - 1]
    differ = np.nonzero(g["tier1_docs"] != c["tier1_docs"])[0]
    check(np.all(np.abs(theta[differ] - cut) <= SGD_ATOL + SGD_RTOL * abs(cut)),
          f"flow-sgd Tier-1 differs away from the boundary: {differ[:8]}")
    for key, want_k in (("lazy", ("bit_matvec", "coverage_gain")),
                        ("agnostic", ("bit_matvec", "coverage_gain")),
                        ("isk1", ("bit_matvec", "coverage_gain")),
                        ("isk2", ("bit_matvec", "coverage_gain")),
                        ("stochastic", ("bit_matvec", "coverage_gain")),
                        ("lazy-caps", ("bit_matvec", "partition_gain")),
                        ("multitier", ("bit_matvec", "coverage_gain"))):
        check(all(gpu["launches"][key].get(k, 0) > 0 for k in want_k),
              f"{key} launched none of {want_k}: {gpu['launches'][key]}")
    mg = main["greedy"]
    log(f"[phase 2] other solvers (cuda s / cpu s, selections, evals): "
        + "; ".join(f"{k} {gpu['seconds'][k]:.2f}/{cpu['seconds'][k]:.2f} "
                    f"{len(gpu[k].order)} {gpu[k].n_exact_evals}"
                    for k in scsk + ["lazy-caps"])
        + f"; greedy {len(mg.order)} selections, {mg.n_exact_evals} evals "
          f"({greedy_evals} in its first {len(lazy)}); multi-tier "
          f"{gpu['seconds']['multitier']:.2f}/{cpu['seconds']['multitier']:.2f}"
          f", flow " + ", ".join(
              f"{k} {gpu['seconds'][k]:.2f}/{cpu['seconds'][k]:.2f}"
              for k in ("flow-popularity", "flow-max", "flow-sgd")))
    log(f"[phase 2] f_final: greedy {mg.f_final:.6f} lazy "
        f"{gpu['lazy'].f_final:.6f} agnostic {gpu['agnostic'].f_final:.6f} "
        f"isk1 {gpu['isk1'].f_final:.6f} isk2 {gpu['isk2'].f_final:.6f} "
        f"stochastic-m2048 {gpu['stochastic'].f_final:.6f}; flow train "
        f"coverage popularity {gpu['flow-popularity'].f_final:.6f} flow-max "
        f"{gpu['flow-max'].f_final:.6f} flow-sgd {gpu['flow-sgd'].f_final:.6f} "
        f"(logits max abs diff card-CPU {np.abs(theta - want).max():.3g}, "
        f"{len(differ)} boundary docs differ)")
    mt = gpu["multitier"]
    log(f"[phase 2] multi-tier {[int(d.sum()) for d in mt.tier_docs]} docs: "
        f"route shares {np.bincount(gpu['routes'], minlength=4).tolist()}, "
        f"verify_multitier true on both devices, routes equal")
    log(f"[phase 2] launches by path: {json.dumps(gpu['launches'])}")


def phase2(counts, scale: str = "medium", device=None) -> dict:
    from repro_torch import api
    from repro_torch.kernels import _build
    t = time.perf_counter()
    pipe = api.TieringPipeline.from_synthetic(0, scale, device=device) \
        .mine(min_support=1e-3)
    mine_s = time.perf_counter() - t
    log(f"[phase 2] {scale}: {pipe.summary()}  mine {mine_s:.1f}s")
    _build.reset_launches()
    gpu = run_pipeline(pipe)
    counts.update(_build.LAUNCHES)
    check(all(counts[k] > 0 for k in MAIN_KERNELS),
          f"a kernel of the main path never launched: {counts}")
    _build.reset_launches()
    gpu_part = run_partitioned(pipe)
    add_counts(counts, _build.LAUNCHES)
    # a fresh pipeline: run_partitioned's refit left the test weights in pipe
    fresh = api.TieringPipeline.from_data(pipe.data, device=pipe.device)
    gpu_solvers = run_solvers(fresh)
    cpu_pipe = api.TieringPipeline.from_data(pipe.data, device="cpu")
    cpu = run_pipeline(cpu_pipe)
    cpu_part = run_partitioned(cpu_pipe)
    cpu_solvers = run_solvers(api.TieringPipeline.from_data(pipe.data,
                                                            device="cpu"))
    for solver in ("greedy", "optpes"):
        g, c = gpu[solver], cpu[solver]
        check(g.order == c.order, f"{solver} order differs from the CPU run")
        check(np.array_equal(g.selected, c.selected), f"{solver} selection differs")
        check(math.isclose(g.f_final, c.f_final, rel_tol=1e-5),
              f"{solver} f_final {g.f_final} vs {c.f_final}")
        check(g.g_final == c.g_final, f"{solver} g_final differs")
    div = gpu["div"]
    check(div is None or div[1], f"greedy and optpes orders differ at {div}")
    check([r.order for r in gpu["sweep"]] == [r.order for r in cpu["sweep"]],
          "sweep order differs from the CPU run")
    check(len(gpu["matches"]) == len(cpu["matches"]) and all(
        np.array_equal(a, b) for a, b in zip(gpu["matches"], cpu["matches"])),
        "match sets differ from the CPU run")
    check(gpu["stats"] == cpu["stats"], "ServeStats differ from the CPU run")
    check(gpu["coverage"] == cpu["coverage"], "coverage differs from the CPU run")
    log(f"[phase 2] cuda: solve {gpu['solve_s']:.2f}s serve {gpu['serve_s']:.2f}s "
        f"sweep {gpu['sweep_s']:.2f}s | cpu: solve {cpu['solve_s']:.2f}s "
        f"serve {cpu['serve_s']:.2f}s sweep {cpu['sweep_s']:.2f}s")
    log(f"[phase 2] greedy/optpes: {len(gpu['greedy'].order)} selections, "
        f"f={gpu['greedy'].f_final:.6f} g={gpu['greedy'].g_final:.0f}; "
        f"coverage {gpu['coverage']}; stats {gpu['stats']}")
    compare_partitioned(gpu_part, cpu_part)
    compare_solvers(gpu_solvers, cpu_solvers, gpu, gpu_part, fresh.problem,
                    float(int(pipe.corpus.n_docs * 0.5)))
    log(f"[phase 2] launches {dict(counts)}; orders, selections, caps, fills, "
        f"match sets and ServeStats equal to the device='cpu' run")
    check(all(counts[k] > 0 for k in TIERING_KERNELS)
          and all(counts[k] == 0 for k in LM_KERNELS),
          f"a kernel never launched, or an LM kernel did: {counts}")
    gpu["data"] = pipe.data
    return gpu


# -- phase 3: the production shapes -------------------------------------------

def zipf(n: int, a: float, device) -> torch.Tensor:
    p = 1.0 / torch.arange(1, n + 1, device=device, dtype=torch.float64) ** a
    return p / p.sum()


def make_postings(gen, v: int, wd: int, device) -> torch.Tensor:
    """Token t's row has density about 2^-k(t), k from 3 (rank 0) to 14
    (rank V-1) falling with Zipf rank: the AND of k random words."""
    ks = (3 + torch.floor(11 * torch.log2(1.0 + torch.arange(v, dtype=torch.float64))
                          / math.log2(v))).clamp(3, 14).long().tolist()
    post = torch.empty((v, wd), dtype=torch.int32, device=device)
    rows = 256
    for r0 in range(0, v, rows):
        kk = ks[r0:r0 + rows]                        # non-decreasing
        acc = rand_words(gen, (len(kk), wd), device)
        for level in range(2, kk[-1] + 1):
            s = next(i for i, k in enumerate(kk) if k >= level)
            acc[s:] &= rand_words(gen, (len(kk) - s, wd), device)
        post[r0:r0 + len(kk)] = acc
    return post


def doc_tokens(postings: torch.Tensor, n_docs: int):
    """CSR of each document's tokens from the packed postings: (ptr [n+1],
    tok [nnz]), tokens ascending within a document."""
    v, wd = postings.shape
    dev = postings.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    toks, docs = [], []
    for r0 in range(0, v, 4096):
        blk = postings[r0:r0 + 4096]
        t, w = torch.nonzero(blk, as_tuple=True)
        bits = ((blk[t, w][:, None] >> shifts) & 1).bool()
        m, b = torch.nonzero(bits, as_tuple=True)
        toks.append(t[m] + r0)
        docs.append(w[m] * 32 + b)
    tok, doc = torch.cat(toks), torch.cat(docs)
    order = torch.sort(doc * v + tok).indices
    ptr = torch.zeros(n_docs + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(doc, minlength=n_docs), 0)
    return ptr, tok[order]


def make_deployment(seed: int, device, *, v=VOCAB, n_docs=N_DOCS,
                    n_queries=N_QUERIES, n_clauses=N_CLAUSES) -> types.SimpleNamespace:
    """A seeded deployment at the production shapes, built on `device`.

    Postings are random with Zipf-falling densities; queries are 1..8
    tokens sub-sampled from random documents' term sets (as
    `data/synthetic.make_query_log` does, so every query matches); train
    and test weights are two multinomial draws from a Zipf over the query
    pool; the clauses are the top-weighted singletons and pairs of the
    train log (the size <= 2 part of what FPGrowth mines).
    """
    from repro_torch.core import bitset
    from repro_torch.kernels import ops
    gen = torch.Generator(device).manual_seed(seed)
    wd, wq = bitset.n_words(n_docs), bitset.n_words(n_queries)
    postings = make_postings(gen, v, wd, device)
    ptr, dtok = doc_tokens(postings, n_docs)

    # queries: distinct tokens of a random non-empty document; duplicates
    # dropped, then a random n_queries of them in random order
    n_cand = 2 * n_queries
    dlen = ptr[1:] - ptr[:-1]
    docs = torch.nonzero(dlen > 0)[:, 0]
    d = docs[torch.randint(0, len(docs), (n_cand,), device=device, generator=gen)]
    lens = torch.empty(n_cand, device=device).geometric_(0.3, generator=gen)
    lens = torch.minimum(lens.clamp(1, SERVE_L).long(), dlen[d])
    pick = (torch.rand((n_cand, SERVE_L), device=device, generator=gen)
            * dlen[d][:, None]).long()
    qt = dtok[ptr[d][:, None] + pick]
    slot = torch.arange(SERVE_L, device=device)
    qt = torch.sort(torch.where(slot[None] < lens[:, None], qt, v), 1).values
    dup = torch.zeros_like(qt, dtype=torch.bool)
    dup[:, 1:] = qt[:, 1:] == qt[:, :-1]
    qt = torch.unique(torch.sort(torch.where(dup, v, qt), 1).values, dim=0)
    check(len(qt) >= n_queries, f"only {len(qt)} distinct queries")
    qt = qt[torch.randperm(len(qt), generator=gen, device=device)[:n_queries]]

    # Zipf train/test weights as two multinomial draws over the query pool
    pool = zipf(n_queries, 0.9, device)
    pool = pool[torch.randperm(n_queries, generator=gen, device=device)]

    def draw(n):
        ids = torch.multinomial(pool, n, replacement=True, generator=gen)
        return (torch.bincount(ids, minlength=n_queries).double() / n).float()

    wtr, wte = draw(2 ** 24), draw(2 ** 24)

    # each query's sub-tuples of size <= 2 as keys a*V+b (a == b: singleton)
    iu, ju = torch.triu_indices(SERVE_L, SERVE_L, 1, device=device)
    keys = torch.cat([qt * v + qt, qt[:, iu] * v + qt[:, ju]], 1)
    ok = torch.cat([qt < v, qt[:, ju] < v], 1)
    qid = torch.arange(n_queries, device=device)[:, None].expand_as(keys)[ok]
    keys = keys[ok]

    # clauses: the n/2 singletons and n/2 pairs of most train weight, ties
    # by key; kept in key order
    uk, inv = torch.unique(keys, return_inverse=True)
    support = torch.zeros(len(uk), dtype=torch.float64, device=device)
    support.index_add_(0, inv, wtr[qid].double())
    is_single = (uk // v) == (uk % v)
    top = []
    for part in (is_single, ~is_single):
        kk, ss = uk[part], support[part]
        check(len(kk) >= n_clauses // 2, "too few distinct sub-tuples")
        top.append(kk[torch.sort(-ss, stable=True).indices[:n_clauses // 2]])
    ckeys = torch.sort(torch.cat(top)).values
    ca, cb = ckeys // v, ckeys % v
    ctoks = torch.stack([ca, torch.where(cb == ca, -1, cb)], 1).to(torch.int32)
    cdb = torch.empty((n_clauses, wd), dtype=torch.int32, device=device)
    for s in range(0, n_clauses, 4096):
        cdb[s:s + 4096] = ops.match_batch(postings, ctoks[s:s + 4096])

    # clause_query_bits: bit q of row c iff clause c ⊆ query q, by looking
    # each query's sub-tuples up among the sorted clause keys
    pos = torch.searchsorted(ckeys, keys).clamp(max=n_clauses - 1)
    hit = ckeys[pos] == keys
    c, q = pos[hit], qid[hit]
    with_clause = float(torch.bincount(q, minlength=n_queries).gt(0).float().mean())
    cqb = torch.zeros(n_clauses * wq, dtype=torch.int32, device=device)
    # distinct (clause, query) pairs: the sum of their bits is their OR
    cqb.index_add_(0, c * wq + (q >> 5), bitset._as_int32(1 << (q & 31)))
    cqb = cqb.view(n_clauses, wq)

    qt32 = torch.where(qt < v, qt, -1).to(torch.int32)
    clauses = [tuple(t for t in row if t >= 0) for row in ctoks.tolist()]
    return types.SimpleNamespace(
        postings=postings, clause_doc_bits=cdb, clause_query_bits=cqb,
        clauses=clauses, clause_tokens=ctoks, query_tokens=qt32, train_weights=wtr,
        test_weights=wte, vocab_size=v, n_docs=n_docs, n_queries=n_queries,
        with_clause=with_clause, doc_len=float(dlen.float().mean()), gen=gen)


def first_divergence(problem, a: list[int], b: list[int]):
    """(index, exact_tie) of the first place two orders differ, or None."""
    from repro_torch.core.greedy import ratio_of
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return None if len(a) == len(b) else (min(len(a), len(b)), False)
    st = problem.state_for(a[:i])
    r = ratio_of(problem.f_gains(st.covered_q), problem.g_gains(st.covered_d))
    return i, bool(r[a[i]] == r[b[i]])


def phase3(seed: int, counts: dict, dev=torch.device("cuda"),
           min_peak: int = 40 * 2 ** 30, **sizes) -> dict:
    from repro_torch.core import bitset, registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.problem import SCSKProblem
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.kernels import _build, ops
    from repro_torch.serve.engine import TieredEngine
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    d = make_deployment(seed, dev, **sizes)
    torch.cuda.synchronize()
    log(f"[phase 3] deployment built in {time.perf_counter() - t:.1f}s: "
        f"V={d.vocab_size} docs={d.n_docs} queries={d.n_queries} "
        f"clauses={len(d.clauses)}; mean doc length {d.doc_len:.2f} tokens; "
        f"{d.with_clause:.3f} of queries contain a clause; "
        f"reduced {json.dumps(REDUCED)}")

    _build.reset_launches()
    problem = SCSKProblem(d.clause_query_bits, d.clause_doc_bits,
                          d.train_weights, d.test_weights,
                          d.n_queries, d.n_docs)
    budget = float(int(d.n_docs * 0.5))
    results = {}
    for solver, opts in (("greedy", {}), ("optpes", {"k": REFRESH_K})):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=budget, solver=solver, max_steps=128, options=opts))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        steps = np.diff(res.time_history) * 1e3
        results[solver] = res
        log(f"[phase 3] {res.summary()} in {dt:.2f}s; per selection ms: "
            f"median {np.median(steps):.3f} max {steps.max():.3f}")
    div = first_divergence(problem, results["greedy"].order,
                           results["optpes"].order)
    if div is not None:
        log(f"[phase 3] greedy and optpes orders first differ at {div[0]} "
            f"(exact ratio tie: {div[1]})")
        check(div[1], "greedy and optpes orders differ without a tie")

    tiering = ClauseTiering.from_selection(d, results["greedy"].selected)
    engine = TieredEngine(d.postings, tiering, d.n_docs)
    test_p = d.test_weights.double() / d.test_weights.double().sum()
    batches = []
    for _ in range(2):
        ids = torch.multinomial(test_p, SERVE_B, replacement=True,
                                generator=d.gen)
        toks = d.query_tokens[ids].tolist()
        qs = [tuple(t for t in row if t >= 0) for row in toks]
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = engine.serve(qs)
        dt = time.perf_counter() - t
        ref = engine.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "phase 3 serve != serve_reference")
        batches.append((qs, dt, sum(len(m) for m in got)))
    torch.cuda.synchronize()
    counts.update(_build.LAUNCHES)
    s = engine.stats
    log(f"[phase 3] serve batches of {SERVE_B}: "
        + ", ".join(f"{dt * 1e3:.1f} ms ({n} matched docs)" for _, dt, n in batches)
        + f"; == serve_reference; tier1_fraction {s.tier1_fraction:.4f} "
          f"(eligible share), tier-1 docs {tiering.tier1_docs.mean():.4f}, "
          f"cost_saving {s.cost_saving:.4f}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[phase 3] launches {dict(counts)}; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB")
    check(all(counts[k] > 0 for k in MAIN_KERNELS),
          f"a kernel of the main path never launched: {counts}")
    check(peak >= min_peak, f"phase 3 held less than {min_peak / 2 ** 30} GiB")
    # where a serve batch's time goes: the engine's steps, one at a time
    qs = batches[0][0]
    live = engine._live

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    toks, ms_tok = host_ms(lambda: engine._tokens(qs))
    qbits, ms_pack = host_ms(lambda: bitset.pack_tokens(toks, d.vocab_size))
    (match, _), ms_match = host_ms(lambda: ops.fused_match(
        qbits, live.clause_bits, toks, live.postings_t1, engine.postings_t2))
    _, ms_ids = host_ms(lambda: bitset.rows_to_indices(match, d.n_docs))
    log(f"[phase 3] serve batch breakdown (host clock, ms): token batch to "
        f"device {ms_tok:.2f}, pack_tokens {ms_pack:.2f}, fused_match "
        f"{ms_match:.2f}, doc ids {ms_ids:.2f}")
    state = problem.state_for(results["greedy"].order)
    return dict(problem=problem, state=state, engine=engine, tokens=toks,
                qbits=qbits, peak=peak, gen=d.gen, vocab=d.vocab_size,
                clause_tokens=d.clause_tokens, queries=qs,
                greedy=results["greedy"], greedy_order=results["greedy"].order,
                clauses=d.clauses, query_tokens=d.query_tokens,
                train_weights=d.train_weights, test_weights=d.test_weights)


def phase3_shards(p3: dict, counts: dict) -> dict:
    """Partitioned greedy and optpes at the production shapes: 8 word-aligned
    shards, each capped at half of the global greedy's fill there after 128
    selections, so the caps bind."""
    from repro_torch.core import bitset, registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.constraint import PartitionedBudget, partition_bounds
    from repro_torch.kernels import _build
    problem, state = p3["problem"], p3["state"]
    bounds = partition_bounds(problem.n_docs, N_PARTS)
    covered = bitset.to_numpy(state.covered_d)
    global_fills = np.array([bitset.np_popcount(covered[lo:hi])
                             for lo, hi in zip(bounds, bounds[1:])], np.float64)
    constraint = PartitionedBudget(global_fills / 2, bounds)
    caps = constraint.caps.astype(np.float64)
    check(np.any(global_fills > caps), "the per-shard caps do not bind")
    _build.reset_launches()
    results, per_sel = {}, {}
    for solver, opts in (("greedy", {}), ("optpes", {"k": REFRESH_K})):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=constraint.total, solver=solver, constraint=constraint,
            max_steps=128, options=opts))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        steps = np.diff(res.time_history) * 1e3
        results[solver] = res
        per_sel[solver] = float(np.median(steps)) if len(steps) else None
        check(np.all(res.extra["g_part"] <= caps), f"{solver} overfills a shard")
        log(f"[phase 3] per-shard {res.summary()} in {dt:.2f}s; per selection "
            f"ms: median {per_sel[solver]} max "
            f"{steps.max() if len(steps) else None}; fills "
            f"{res.extra['g_part'].tolist()}")
    add_counts(counts, _build.LAUNCHES)
    check(_build.LAUNCHES["partition_gain"] > 0 and _build.LAUNCHES["bit_matvec"] > 0,
          f"a kernel of the per-shard path never launched: {_build.LAUNCHES}")
    ordered_or_tied(problem, results["greedy"].order, results["optpes"].order,
                    "per-shard greedy vs optpes (production shapes)")
    glob = p3["greedy_order"]
    depart = next((i for i, (x, y) in enumerate(zip(glob, results["greedy"].order))
                   if x != y), None)
    log(f"[phase 3] per-shard caps {caps.tolist()} (global greedy fills "
        f"{global_fills.tolist()}); per-shard greedy departs from the global "
        f"order at selection {depart}; launches {dict(_build.LAUNCHES)}")
    return dict(per_selection_ms=per_sel, caps=caps.tolist(),
                fills=results["greedy"].extra["g_part"].tolist(),
                selections=len(results["greedy"].order), depart=depart)


def padded_ids_device(words: torch.Tensor, keep: torch.Tensor, m: int,
                      rows: int = 4096) -> torch.Tensor:
    """Each kept row's set bits as a sorted int32 list padded with -1 to
    `m` (all -1 for the other rows), built on the device in row chunks.
    Every kept row must have at most `m` bits."""
    c = words.shape[0]
    dev = words.device
    ids = torch.full((c, m), -1, dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    for r0 in range(0, c, rows):
        blk = words[r0:r0 + rows] * keep[r0:r0 + rows, None]
        r, w = torch.nonzero(blk, as_tuple=True)          # row-major
        bits = ((blk[r, w][:, None] >> shifts) & 1).bool()
        k, b = torch.nonzero(bits, as_tuple=True)         # bit-ascending
        row, doc = r[k], w[k] * 32 + b
        n = torch.bincount(row, minlength=blk.shape[0])
        start = torch.cumsum(n, 0) - n
        pos = torch.arange(len(row), device=dev) - start[row]
        ids[r0 + row, pos] = doc.to(torch.int32)
    return ids


def phase3_sparse(p3: dict, counts: dict) -> dict:
    """The sparse greedy round at the production shapes over the clauses
    with |m(c)| <= SPARSE_M, against dense greedy over the same rows (the
    longer clauses get an all -1 list and start selected in both)."""
    from repro_torch.core.state import SolverState
    from repro_torch.kernels import _build, ops
    problem = p3["problem"]
    dev = problem.device
    sizes = ops.coverage_gain(problem.clause_doc_bits,
                              torch.zeros_like(problem.clause_doc_bits[0]))
    short = sizes <= SPARSE_M
    ids = padded_ids_device(problem.clause_doc_bits, short, SPARSE_M)
    check(torch.equal((ids >= 0).sum(1, dtype=torch.int32),
                      torch.where(short, sizes, 0)), "padded id lists lost ids")
    start = SolverState(
        covered_q=torch.zeros_like(problem.clause_query_bits[0]),
        covered_d=torch.zeros_like(problem.clause_doc_bits[0]),
        selected=~short, g_used=torch.zeros((), device=dev), step=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    res = sparse_round(problem, ids, start, float(int(problem.n_docs * 0.5)), 128)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    add_counts(counts, _build.LAUNCHES)
    check(_build.LAUNCHES["sparse_gain"] > 0, "the sparse round never launched sparse_gain")
    n = max(1, len(res["order"]))
    log(f"[phase 3] sparse round over {int(short.sum())} of {len(short)} "
        f"clauses (M={SPARSE_M}): {len(res['order'])} selections, "
        f"g={res['g_used']:.0f}, == dense greedy (orders and covered docs); "
        f"{dt:.2f}s, per selection sparse {res['sparse_s'] / n * 1e3:.3f} ms vs "
        f"dense {res['dense_s'] / n * 1e3:.3f} ms; launches {dict(_build.LAUNCHES)}")
    return dict(ids=ids, covered_d=res["covered_d"], selections=len(res["order"]),
                sparse_ms=res["sparse_s"] / n * 1e3,
                dense_ms=res["dense_s"] / n * 1e3)


PROD_SOLVERS = (("lazy", {}), ("agnostic", {}),
                ("stochastic", {"batch_queries": 2048}),
                ("isk1", {"max_outer": 3, "max_inner": 128}),
                ("isk2", {"max_outer": 3, "max_inner": 128}))
# lazy's eq.-14 lower bounds fall to 0 within a few selections when each
# selection adds ~1 doc, and every clause with g̲ = 0 is then re-evaluated
# one row at a time; its run stops at this wall-clock limit
LAZY_LIMIT_S = 30.0


def per_step_ms(res) -> tuple[float, float]:
    """Median and maximum ms between a solve's recorded points (a selection,
    or one ISK outer iteration)."""
    steps = np.diff(res.time_history) * 1e3
    return float(np.median(steps)), float(steps.max())


def phase3_solvers(p3: dict) -> dict:
    """lazy, agnostic, stochastic and ISK at the production shapes, 128
    selections each (ISK: 3 outer iterations of at most 128), each run's
    launches counted from 0; then one exact evaluation (lazy's and
    agnostic's unit of work) timed alone on 64 clauses at lazy's final
    state. lazy == greedy up to an f32 tie."""
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.constraint import GlobalBudget
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import _build
    problem = p3["problem"]
    budget = float(int(problem.n_docs * 0.5))
    out: dict = {}
    for name, opts in PROD_SOLVERS:
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=budget, solver=name, max_steps=128, options=opts,
            time_limit=LAZY_LIMIT_S if name == "lazy" else None))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(launches.get("bit_matvec", 0) > 0
              and launches.get("coverage_gain", 0) > 0,
              f"{name} at production shapes launched {launches}")
        med, mx = per_step_ms(res)
        out[name] = dict(result=res, s=dt, median_ms=med, max_ms=mx,
                         evals=res.n_exact_evals, launches=launches)
        if name.startswith("isk"):
            check(np.all(res.g_history <= budget), f"{name} exceeds B")
    greedy = p3["greedy"]
    lazy_order = out["lazy"]["result"].order
    ordered_or_tied(problem, lazy_order, greedy.order[:len(lazy_order)],
                    "lazy vs greedy (production shapes)")
    # one exact evaluation: a one-row bit_matvec and a one-row coverage_gain
    # launch, read to the host in one transfer
    st = out["lazy"]["result"].state
    x = problem.uncovered_weights(st.covered_q)
    cons = GlobalBudget(budget)
    js = torch.randperm(problem.n_clauses, generator=p3["gen"],
                        device=p3["gen"].device)[:64].tolist()
    _exact_gains_one(problem, cons, x, st.covered_d, js[0])        # warm-up
    one = []
    for j in js:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _exact_gains_one(problem, cons, x, st.covered_d, j)
        one.append((time.perf_counter() - t) * 1e3)
    out["exact_eval_ms"] = float(np.median(one))
    out["exact_eval_max_ms"] = float(np.max(one))
    g_med, g_max = per_step_ms(greedy)
    out["greedy"] = dict(median_ms=g_med, max_ms=g_max,
                         evals=greedy.n_exact_evals)
    log(f"[phase 3] greedy (same run): {g_med:.3f} ms per selection median, "
        f"{g_max:.3f} max, {greedy.n_exact_evals} evals")
    for name, _ in PROD_SOLVERS:
        r = out[name]
        unit = "outer iteration" if name.startswith("isk") else "selection"
        log(f"[phase 3] {r['result'].summary()} in {r['s']:.2f}s; per {unit} "
            f"ms: median {r['median_ms']:.3f} max {r['max_ms']:.3f}; launches "
            f"{r['launches']}")
    lz = out["lazy"]
    n_sel = len(lz["result"].order)
    out["lazy_exact_evals"] = (lz["evals"] - 2 * problem.n_clauses) // 2
    log(f"[phase 3] one exact evaluation (one-row bit_matvec + coverage_gain "
        f"+ one host read): median {out['exact_eval_ms']:.4f} ms, max "
        f"{out['exact_eval_max_ms']:.4f} ms over 64 clauses; lazy made "
        f"{out['lazy_exact_evals']} exact evaluations in {n_sel} selections "
        f"({'its ' + str(LAZY_LIMIT_S) + ' s limit' if n_sel < 128 else 'all 128'}"
        f"), == greedy's first {n_sel} up to f32 ties")
    return out


def phase3_telemetry(p3: dict) -> dict:
    """The telemetry plane at the production shapes: the kernel profiler's
    measured rows for one greedy step and one serve batch (each row at most
    1.05 of the H100's HBM roofline), the word counters equal to the ops'
    word models over the calls made, and a greedy solve and a serve batch
    bit-identical with the plane off."""
    from repro_torch import obs
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.greedy import greedy_step
    from repro_torch.kernels import ops
    problem, engine, qs = p3["problem"], p3["engine"], p3["queries"]
    budget = float(int(problem.n_docs * 0.5))
    prev = obs.set_enabled(True)
    obs.reset()
    with obs.PROFILER.scoped():
        with obs.PROFILER.measuring():
            greedy_step(problem, p3["state"], budget)
            engine.serve(qs)
        rows = obs.PROFILER.summary()
    path = ops.path_of(problem.clause_query_bits)
    check(path == "cuda", f"the telemetry check's launches ran on {path}")
    words = {s["labels"]["op"]: s["value"] for s in obs.REGISTRY.get(
        "kernel_words_scanned_total").to_dict()["series"]
        if s["labels"]["path"] == path}
    c, k = problem.n_clauses, engine._live.clause_bits.shape[0]
    want = {"bit_matvec": c * problem.wq, "coverage_gain": c * problem.wd,
            "clause_match": (len(qs) + k) * engine._live.clause_bits.shape[1]}
    check(words == want, f"kernel words {words} != the word models {want}")
    for r in rows:
        log(f"[phase 3] profiler {r['op']} ({r['path']}): {r['calls']} call, "
            f"{r['us_per_call']:.1f} us, {r['achieved_gbps']:.1f} GB/s, "
            f"roofline_frac {r['roofline_frac']:.4f} of {obs.HBM_BW / 1e12} TB/s")
        check(r["roofline_frac"] <= 1.05, f"roofline_frac above 1.05: {r}")
    check({r["op"] for r in rows} == set(want), f"profiler rows {rows}")
    # the plane off: the same solve and serve, bit for bit
    runs = []
    for on in (True, False):
        obs.set_enabled(on)
        res = registry.solve(problem, SolveConfig(budget=budget,
                                                  solver="greedy",
                                                  max_steps=32))
        runs.append((res, engine.serve(qs)))
    obs.set_enabled(prev)
    (a, sa), (b, sb) = runs
    check(a.order == b.order and a.f_final == b.f_final
          and np.array_equal(a.selected, b.selected)
          and all(np.array_equal(x, y) for x, y in zip(sa, sb)),
          "results differ with the telemetry plane off")
    log(f"[phase 3] telemetry: words {words} == the ops' word models; greedy "
        f"(32 selections) and a serve batch bit-identical with the plane off; "
        f"{obs.dashboard()}")
    return dict(rows=rows, words=words)


# -- phase 5: streaming re-tiering and the sharded fleet ----------------------

STREAM_WINDOWS, STREAM_QPW = 8, 512     # 5a: `medium`, card == CPU
STREAM_STEPS, STREAM_HOLD = 64, 2       # 5a: selections per solve, refit spacing
PROD_WINDOWS = 6                        # 5b: rotate windows of SERVE_B queries
FLEET_SHARDS = 8                        # 5c: 1 replica per tier
LAUNCHERS = (
    ("stream", ["--scale", "small", "--windows", "12", "--verify"]),
    ("cluster", ["--scale", "small", "--shards", "4", "--replicas", "2",
                 "--budget-split", "traffic", "--cache", "--verify"]),
)


def recording_controller():
    """The port's RetieringController, keeping each refit's selection order."""
    from repro_torch.stream import RetieringController

    class Recording(RetieringController):
        def __init__(self, *args, **kw):
            self.orders: list[list[int]] = []
            super().__init__(*args, **kw)

        def _refit(self, solve_w, raw_w, report):
            super()._refit(solve_w, raw_w, report)
            self.orders.append(list(self.pipe.result.order))
    return Recording


def stream_run(pipe, *, windows: int, qpw: int, seed: int = 0, **ctrl_kw):
    """A rotate replay through a recording controller, as `run_stream` runs
    it; returns (StreamReport, controller)."""
    from repro_torch import stream
    sim = stream.TrafficSimulator(pipe.log, "rotate", seed=seed,
                                  n_windows=windows, queries_per_window=qpw)
    ctrl = recording_controller()(pipe, **ctrl_kw)
    return ctrl.run(sim), ctrl


def quick_detector(hold: int = 1):
    """The drift detector without its sampling-noise floor, refits at least
    `hold` windows apart. The floor, 0.5 sqrt(2/(pi n)) sum_q sqrt(p_q) for
    n decayed samples, is 1.4-2.0 at `medium` with 512-query windows and
    larger over phase 3's 2^20 queries (5b logs it), and a TV never
    exceeds 1, so with it no refit would trigger."""
    from repro_torch import stream
    return stream.DriftDetector(noise_scale=0.0, min_windows_between=hold)


def window_fields(report) -> list[dict]:
    """Every WindowReport field but the wall-clock refit_seconds."""
    return [{k: v for k, v in w.to_dict().items() if k != "refit_seconds"}
            for w in report.windows]


def medium_stream(data, device, static: bool) -> dict:
    """5a on one device: greedy (64 selections) served by the engine under
    the re-tiering loop, then a traffic-split greedy served by a 4-shard
    fleet (2 Tier-1 replicas, the result cache) under the same loop; each
    path's launches counted from 0."""
    from repro_torch import api, stream
    from repro_torch.kernels import _build
    kw = dict(windows=STREAM_WINDOWS, qpw=STREAM_QPW, verify_swaps=True)
    run_kw = dict(scenario="rotate", n_windows=STREAM_WINDOWS,
                  queries_per_window=STREAM_QPW, seed=0)
    out: dict = {"launches": {}, "seconds": {}}
    solve = dict(budget_frac=0.5, max_steps=STREAM_STEPS)
    for arm, split in (("engine", {}),
                       ("fleet", dict(budget_split="traffic", n_shards=4))):
        pipe = api.TieringPipeline.from_data(data, device=device).solve(
            "greedy", **solve, **split)
        if static:
            out[f"{arm}_static"] = stream.run_stream(
                pipe, enable_refit=False, **run_kw)
        fleet = pipe.deploy_cluster(n_shards=4, t1_replicas=2, cache=True) \
            if arm == "fleet" else None
        _build.reset_launches()
        t = time.perf_counter()
        rep, ctrl = stream_run(pipe, engine=fleet,
                               detector=quick_detector(STREAM_HOLD), **kw)
        out["seconds"][arm] = time.perf_counter() - t
        out["launches"][arm] = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[arm] = dict(report=rep, orders=ctrl.orders,
                        windows=window_fields(rep),
                        cumulative=rep.cumulative.to_dict())
        if fleet is not None:
            out[arm].update(consistent=fleet.consistency_ok(),
                            fleet_stats=fleet.stats.to_dict(),
                            cache=fleet.cache.snapshot(),
                            traces=[dataclasses.astuple(x) for x in fleet.trace],
                            shards=[(s.n_words, s.word_lo) for s in fleet.shards])
    return out


def phase5_medium(data, card=torch.device("cuda")) -> dict:
    gpu = medium_stream(data, card, static=True)
    host = medium_stream(data, torch.device("cpu"), static=False)
    for arm in ("engine", "fleet"):
        g, c = gpu[arm], host[arm]
        check(g["windows"] == c["windows"],
              f"5a {arm}: window reports differ from the CPU run")
        check(g["cumulative"] == c["cumulative"],
              f"5a {arm}: cumulative ServeStats differ from the CPU run")
        check(g["orders"] == c["orders"],
              f"5a {arm}: refit orders differ from the CPU run")
        rep, static = g["report"], gpu[f"{arm}_static"]
        check(rep.n_refits > 0 and rep.n_parity_checks > 0
              and rep.parity_all_ok(),
              f"5a {arm}: no refit, or a swap broke Theorem 3.1")
        check(rep.cumulative.n_queries == static.cumulative.n_queries,
              f"5a {arm}: windows dropped")
        log(f"[phase 5] medium {arm}: retiered {rep.summary()} | static "
            f"{static.summary()} ({rep.mean_coverage - static.mean_coverage:+.4f})"
            f"; cuda {gpu['seconds'][arm]:.2f}s cpu {host['seconds'][arm]:.2f}s; "
            f"launches {json.dumps(gpu['launches'][arm])}")
        for w in rep.windows:
            log(f"[phase 5]   {w.line()}")
    check(gpu["engine"]["report"].mean_coverage
          > gpu["engine_static"].mean_coverage,
          "5a: the retiered engine's mean coverage does not beat static")
    g, c = gpu["fleet"], host["fleet"]
    check(g["consistent"] and c["consistent"], "5a: a fleet batch saw a "
          "mixed (ψ, Tier-1, Tier-2) triple")
    for key in ("fleet_stats", "cache", "traces"):
        check(g[key] == c[key], f"5a fleet: {key} differ from the CPU run")
    for arm, want in (("engine", MAIN_KERNELS),
                      ("fleet", ("bit_matvec", "partition_gain",
                                 "clause_match", "tier_match"))):
        got = gpu["launches"][arm]
        check(all(got.get(k, 0) > 0 for k in want),
              f"5a {arm}: a kernel of the path never launched: {got}")
    log(f"[phase 5] medium: windows, refit orders, cumulative and fleet stats, "
        f"BatchTraces and the result cache equal to the device='cpu' run; "
        f"fleet shards (words, first word) {g['shards']}, cache {g['cache']}")
    return gpu


def clocked(fn, sink: list, key: str):
    """`fn` with its wall time (a CUDA sync on both sides) appended to
    `sink` as (key, seconds)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((key, time.perf_counter() - t))
        return out
    return run


def phase5_production(p3: dict) -> dict:
    """5b: the re-tiering loop over phase 3's problem, engine and greedy
    state. The pipeline is phase 3's problem behind a `TieringPipeline`
    whose log holds the 2^20 queries and phase 3's weights."""
    import repro_torch.stream.controller as controller_mod
    from repro_torch import api, stream
    from repro_torch.core import bitset
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.kernels import _build
    problem, engine = p3["problem"], p3["engine"]
    t = time.perf_counter()
    qt = p3["query_tokens"]
    queries = [tuple(x for x in row if x >= 0) for row in qt.tolist()]
    log_ = types.SimpleNamespace(
        queries=queries, n_queries=len(queries),
        train_weights=p3["train_weights"].double().cpu().numpy(),
        test_weights=p3["test_weights"].double().cpu().numpy())
    n_docs = problem.n_docs
    corpus = types.SimpleNamespace(n_docs=n_docs)
    pipe = api.TieringPipeline(corpus, log_, device=problem.device)
    pipe.data = types.SimpleNamespace(
        clauses=p3["clauses"], vocab_size=p3["vocab"], n_docs=n_docs,
        clause_doc_bits=problem.clause_doc_bits, log=log_, corpus=corpus)
    pipe.problem = problem
    pipe.config = SolveConfig(budget=float(int(n_docs * 0.5)),
                              solver="greedy", max_steps=128)
    pipe.result = p3["greedy"]
    t0 = engine.tiering
    adapter_s = time.perf_counter() - t
    # refits 3 windows apart (windows 2 and 5)
    detector = quick_detector(hold=3)
    prior = log_.train_weights / log_.train_weights.sum()
    floor = 0.5 * math.sqrt(2 / (math.pi * (32 + SERVE_B))) * \
        float(np.sqrt(prior).sum())
    parts: list = []
    sim = stream.TrafficSimulator(log_, "rotate", seed=0,
                                  n_windows=PROD_WINDOWS,
                                  queries_per_window=SERVE_B)
    ctrl = recording_controller()(pipe, engine=engine, detector=detector,
                                  verify_swaps=True)
    elig0 = ctrl._eligible(t0)           # computed (and cached) by __init__
    pipe.refit = clocked(pipe.refit, parts, "solve")
    engine.prepare_tiering = clocked(engine.prepare_tiering, parts, "prepare")
    engine.swap_tiering = clocked(engine.swap_tiering, parts, "swap")
    engine.serve = clocked(engine.serve, parts, "serve")
    ctrl._eligible = clocked(ctrl._eligible, parts, "eligibility")
    prune = controller_mod.prune_state
    controller_mod.prune_state = clocked(prune, parts, "prune")
    reports, refits, windows, serve_ms, static = [], [], [], [], []
    _build.reset_launches()
    try:
        for w in sim.windows():
            n0 = len(parts)
            rep = ctrl.step(w)
            qs = [queries[i] for i in w.query_ids]
            windows.append((w.query_ids, qs))
            # the window's own batch is the step's first serve
            serve_ms.append(next(s for k, s in parts[n0:] if k == "serve") * 1e3)
            if rep.refit:
                # the whole window again on the new generation == the oracle
                got = engine.serve(qs)
                ref = engine.serve_reference(qs)
                check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
                      f"5b window {w.index}: serve != serve_reference after "
                      f"the swap")
                split = {}
                for k, s in parts[n0:]:
                    if k != "serve":
                        split[k] = split.get(k, 0.0) + s
                refits.append(dict(window=w.index, kind=rep.refit,
                                   steps=rep.refit_steps, pruned=rep.pruned,
                                   seconds=rep.refit_seconds, parts=split))
            reports.append(rep)
            # the static tiering's coverage of the same window
            static.append(float(elig0[w.query_ids].mean()))
            log(f"[phase 5] production {rep.line()}  static {static[-1]:.3f}"
                f"  serve {serve_ms[-1]:.1f} ms")
    finally:
        controller_mod.prune_state = prune
        for obj, name in ((pipe, "refit"), (engine, "prepare_tiering"),
                          (engine, "swap_tiering"), (engine, "serve")):
            delattr(obj, name)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(launches.get(k, 0) > 0 for k in MAIN_KERNELS),
          f"5b: a kernel of the re-tiering path never launched: {launches}")
    check(refits and all(r.parity_ok for r in reports if r.refit),
          f"5b: no refit, or a parity check failed")
    # eligibility through clause_match == classify_queries on a sample, for
    # the first and the last tiering; the projection onto the vocabulary
    # words some clause uses is exact (a word no clause uses passes)
    ids = windows[0][0]
    qbits = bitset.to_numpy(bitset.pack_tokens(
        qt[torch.from_numpy(ids).to(qt.device)], p3["vocab"]))
    for tiering in (t0, engine.tiering):
        elig = ctrl._eligible(tiering)
        cols = np.nonzero(tiering.clause_vocab_bits.any(0))[0]
        sub = ClauseTiering(tiering.clauses, tiering.clause_vocab_bits[:, cols],
                            tiering.tier1_docs, tiering.vocab_size)
        want = sub.classify_queries(qbits[:, cols], chunk=512)
        check(np.array_equal(elig[ids], want),
              "5b: clause_match eligibility != classify_queries")
    log(f"[phase 5] production: adapter {adapter_s:.2f}s; the detector's "
        f"noise floor at window 0 would be {floor:.2f}; {len(refits)} refits "
        + "; ".join(f"window {r['window']} {r['kind']} {r['steps']} steps "
                    f"-{r['pruned']} {r['seconds']:.3f}s ("
                    + ", ".join(f"{k} {v:.3f}s" for k, v in r["parts"].items())
                    + ")" for r in refits)
        + f"; mean coverage retiered "
          f"{np.mean([r.coverage for r in reports]):.4f}, static "
          f"{np.mean(static):.4f}"
        + f"; eligibility over {len(queries)} queries == classify_queries "
          f"on a {SERVE_B}-query sample; launches {launches}")
    return dict(t0=t0, t1=engine.tiering, refits=refits,
                windows=[qs for _, qs in windows], launches=launches,
                serve_ms=serve_ms)


def phase5_fleet(postings, n_docs: int, p5: dict) -> dict:
    """5c: an 8-shard fleet (1 replica per tier) over phase 3's postings:
    one batch at the greedy tiering, then a rolling swap to the refit's
    tiering with a batch served per phase until it lands, then the batch
    at the new generation; each batch == the single-tier oracle."""
    from repro_torch.cluster import TieredCluster
    from repro_torch.kernels import _build
    gib = 2 ** 30
    v, w = postings.shape
    free, total = torch.cuda.mem_get_info()
    need = 3 * v * w * 4
    log(f"[phase 5] fleet memory: postings {v * w * 4 / gib:.1f} GiB held; "
        f"Tier-2 shard copies {v * w * 4 / gib:.1f} GiB, Tier-1 sub-indexes "
        f"{v * w * 4 / gib:.1f} GiB per live generation (two mid-rollout): "
        f"{need / gib:.1f} GiB to add, {free / gib:.1f} of {total / gib:.1f} "
        f"GiB free")
    check(free > need + 2 * gib, "5c: the fleet does not fit on the card")
    _build.reset_launches()
    t = time.perf_counter()
    fleet = TieredCluster(postings, p5["t0"], n_docs, n_shards=FLEET_SHARDS,
                          t1_replicas=1, t2_replicas=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    widths = sorted({s.n_words for s in fleet.shards})
    batches = []

    def serve(qs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fleet.serve(qs)
        dt = (time.perf_counter() - t0) * 1e3
        ref = fleet.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "5c: fleet batch != the single-tier oracle")
        tr = fleet.trace[-1]
        batches.append(dict(ms=dt, psi_generation=tr.psi_generation,
                            n_tier1=tr.n_tier1, n_tier2=tr.n_tier2))

    first, second = p5["windows"][0], p5["windows"][-1]
    serve(first)
    t = time.perf_counter()
    gen = fleet.swap_tiering(p5["t1"])
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t
    n_roll = 0
    while fleet.router.rollout is not None:
        serve(second)
        n_roll += 1
    serve(second)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(fleet.consistency_ok(), "5c: a BatchTrace is not consistent")
    check(batches[-1]["psi_generation"] == gen and batches[0]["psi_generation"] == 0,
          f"5c: served generations {[b['psi_generation'] for b in batches]}")
    check(all(launches.get(k, 0) > 0 for k in ("clause_match", "tier_match")),
          f"5c: a kernel of the fleet path never launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    t1 = [b["ms"] for b in batches if b["psi_generation"] >= 0]
    fb = [b["ms"] for b in batches if b["psi_generation"] < 0]
    log(f"[phase 5] fleet: {fleet.describe()}; shard widths {widths} words "
        f"(tier_match's vector path needs a multiple of 4: "
        f"{all(x % 4 == 0 for x in widths)}); built in {build_s:.2f}s, next "
        f"generation prepared in {prepare_s:.2f}s, rolled over {n_roll} "
        f"batches; {len(batches)} batches of {SERVE_B} == the oracle, traces "
        f"consistent; ms per batch: Tier-1 generations "
        f"{[round(x, 1) for x in t1]}, Tier-2 fallback "
        f"{[round(x, 1) for x in fb]} (single engine, 5b's windows: "
        f"{[round(x, 1) for x in p5['serve_ms']]}); launches {launches}; "
        f"max_memory_allocated {peak / gib:.2f} GiB")
    return dict(batches=batches, launches=launches, widths=widths,
                build_s=build_s, prepare_s=prepare_s)


def start_launchers(root: Path) -> list:
    """5d: the two launchers as users run them, as subprocesses on the card."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = []
    for name, args in LAUNCHERS:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{name}", *args]
        procs.append((name, cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_launchers(procs: list) -> None:
    """Wait for each launcher; each must exit 0."""
    for name, cmd, t0, p in procs:
        out, _ = p.communicate(timeout=600)
        log(f"[phase 5] {' '.join(cmd[2:])}: exit {p.returncode}, collected "
            f"{time.perf_counter() - t0:.1f}s after its start")
        for ln in out.strip().splitlines()[-4:]:
            log(f"[phase 5]   {ln}")
        check(p.returncode == 0, f"5d: launch.{name} exited {p.returncode}:"
              f"\n{out[-3000:]}")


def bound(nbytes, flops=0.0) -> tuple[float, str]:
    """The least time (ms) the card could take and what sets it: bytes over
    the HBM rate or FP64 operations over the FP64 rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase1_scale(p3: dict) -> list[dict]:
    """Each kernel at the phase-3 shapes: agreement with its plain version
    (on a seeded sample of 512 rows where the plain output would be the full
    matrix), median time, plain time and bound."""
    from repro_torch.core import bitset
    from repro_torch.kernels import ops, ref
    problem, state, engine = p3["problem"], p3["state"], p3["engine"]
    gen = p3["gen"]
    rec = []

    def sample(n):
        return torch.randperm(n, generator=gen, device=gen.device)[:512]

    # coverage_gain: g-gains of every clause at the greedy prefix
    a, mask = problem.clause_doc_bits, state.covered_d
    c, w = a.shape
    out = ops.coverage_gain(a, mask)
    idx = sample(c)
    err = int((out[idx] - ref.coverage_gain(a[idx], mask)).abs().max())
    check(err == 0, "coverage_gain disagrees at scale")
    b_ms, b_by = bound(4 * (c * w + w + c))
    rec.append(dict(name="coverage_gain", max_abs_err=err,
                    ms=time_ms(lambda: ops.coverage_gain(a, mask), 20),
                    plain_ms=time_ms(lambda: ref.coverage_gain(a, mask), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w]))

    # bit_matvec: f-gains of every clause at the greedy prefix (R = 1)
    a = problem.clause_query_bits
    x = (problem.query_weights
         * (1.0 - bitset.unpack(state.covered_q).float()))[:, None]
    c, w = a.shape
    out = ops.bit_matvec(a, x)
    idx = sample(c)
    want = ref.bit_matvec(a[idx], x)
    torch.testing.assert_close(out[idx], want, rtol=1e-4, atol=1e-6)
    err = float((out[idx] - want).abs().max())
    nnz = int(ops.coverage_gain(a, torch.zeros_like(a[0])).sum())
    b_ms, b_by = bound(4 * (c * w + w * 32 + c), flops=float(nnz))
    rec.append(dict(name="bit_matvec", max_abs_err=err,
                    ms=time_ms(lambda: ops.bit_matvec(a, x), 20),
                    plain_ms=time_ms(lambda: ref.bit_matvec(a, x), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w, 1], nnz=nnz))

    # clause_match: ψ over a serve batch against the deployed clauses
    q, cl = p3["qbits"], engine._live.clause_bits
    out = ops.clause_match(q, cl)
    err = int((out != ref.clause_match(q, cl)).sum())
    check(err == 0, "clause_match disagrees at scale")
    (bq, wv), k = q.shape, cl.shape[0]
    b_ms, b_by = bound(4 * (bq + k) * wv + bq)
    rec.append(dict(name="clause_match", max_abs_err=err,
                    ms=time_ms(lambda: ops.clause_match(q, cl), 20),
                    device_ms=graph_ms(lambda: ops.clause_match(q, cl)),
                    plain_ms=time_ms(lambda: ref.clause_match(q, cl), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[bq, k, wv],
                    serve_route_k=clause_match_xl(p3)))

    # tier_match: the tier-selected AND-match of that batch
    toks, t1, t2 = p3["tokens"], engine.postings_t1, engine.postings_t2
    sel = out
    got = ops.tier_match(t1, t2, sel, toks)
    err = int((got != ref.tier_match(t1, t2, sel, toks)).sum())
    check(err == 0, "tier_match disagrees at scale")
    (bq, ell), w = toks.shape, t2.shape[1]
    # each needed postings row is read once: distinct (tier, token) pairs
    rows = (sel.long()[:, None] * t2.shape[0] + toks.long())[toks >= 0]
    n_rows = int(torch.unique(rows).numel())
    b_ms, b_by = bound(4 * (n_rows * w + bq * w + bq * ell) + bq)
    rec.append(dict(name="tier_match", max_abs_err=err,
                    ms=time_ms(lambda: ops.tier_match(t1, t2, sel, toks), 20),
                    plain_ms=time_ms(lambda: ref.tier_match(t1, t2, sel, toks), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[bq, ell, w],
                    distinct_rows=n_rows))

    # partition_gain: the 8 per-shard g-gains of every clause at the prefix
    from repro_torch.core.constraint import partition_bounds
    a, mask = problem.clause_doc_bits, state.covered_d
    bounds = partition_bounds(problem.n_docs, N_PARTS)
    (c, w), p = a.shape, len(bounds) - 1
    out = ops.partition_gain(a, mask, bounds)
    idx = sample(c)
    err = int((out[idx] - ref.partition_gain(a[idx], mask, bounds)).abs().max())
    check(err == 0, "partition_gain disagrees at scale")
    b_ms, b_by = bound(4 * (c * w + w + c * p))
    rec.append(dict(name="partition_gain", max_abs_err=err,
                    ms=time_ms(lambda: ops.partition_gain(a, mask, bounds), 20),
                    plain_ms=time_ms(lambda: ref.partition_gain(a, mask, bounds), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w, p]))

    # sparse_gain: the phase-3 id lists against the sparse round's covered
    # docs (2^20 docs: the shared-memory route)
    ids, mask = p3["sparse"]["ids"], p3["sparse"]["covered_d"]
    rec.append(sparse_record(ids, mask, sample(ids.shape[0]), "smem"))
    return rec


def serve_route_inputs(p3: dict) -> dict:
    """The phase-3 serve batch against the deployment's 2^16 candidate
    singletons and pairs (serve_route's K), packed into vocab words, in the
    deployment's vocabulary order and under a random permutation of the
    token ids applied to queries and clauses both; and 256 sampled
    queries."""
    from repro_torch.core import bitset
    gen, v = p3["gen"], p3["vocab"]
    toks, ctoks = p3["tokens"], p3["clause_tokens"]
    perm = torch.randperm(v, generator=gen, device=gen.device).to(torch.int32)

    def permuted(t):
        return torch.where(t >= 0, perm[t.clamp(min=0).long()], -1)

    return dict(q=p3["qbits"], cl=bitset.pack_tokens(ctoks, v),
                q_perm=bitset.pack_tokens(permuted(toks), v),
                cl_perm=bitset.pack_tokens(permuted(ctoks), v),
                idx=torch.randperm(toks.shape[0], generator=gen,
                                   device=gen.device)[:256])


def clause_match_xl(p3: dict) -> dict:
    """clause_match at serve_route's K = 2^16 (`serve_route_inputs`): equal
    to the plain version on the sampled queries in both vocabulary orders,
    identical answers in the two orders; median times in both orders, the
    device time per call (`graph_ms`), the plain version's time on the
    sampled queries, ops.fused_match's at that K, and the bound."""
    from repro_torch.kernels import ops, ref
    x = serve_route_inputs(p3)
    q, cl, qp, clp, idx = x["q"], x["cl"], x["q_perm"], x["cl_perm"], x["idx"]
    out, out_p = ops.clause_match(q, cl), ops.clause_match(qp, clp)
    check(torch.equal(out, out_p),
          "clause_match at K = 2^16 changes under a vocabulary permutation")
    err = int((out[idx] != ref.clause_match(q[idx], cl)).sum()) \
        + int((out_p[idx] != ref.clause_match(qp[idx], clp)).sum())
    check(err == 0, "clause_match disagrees at K = 2^16")
    (bq, wv), k = q.shape, cl.shape[0]
    b_ms, b_by = bound(4 * (bq + k) * wv + bq)
    toks, t1, t2 = p3["tokens"], p3["engine"].postings_t1, p3["engine"].postings_t2
    return dict(shape=[bq, k, wv], max_abs_err=err,
                ms=time_ms(lambda: ops.clause_match(q, cl), 20),
                ms_permuted=time_ms(lambda: ops.clause_match(qp, clp), 20),
                device_ms=graph_ms(lambda: ops.clause_match(q, cl)),
                plain_ms=time_ms(lambda: ref.clause_match(q[idx], cl), 1),
                plain_queries=len(idx), bound_ms=b_ms, bound_by=b_by,
                fused_match_ms=time_ms(
                    lambda: ops.fused_match(q, cl, toks, t1, t2), 20),
                eligible=float(out.float().mean()))


def sparse_record(ids: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                  route: str) -> dict:
    """sparse_gain on `ids` against `mask`: agreement with the plain version
    on the rows `idx`, median time, plain time and bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sparse_gain import smem_route
    check(smem_route(mask.shape[0]) == (route == "smem"),
          f"sparse_gain takes another route than {route} here")
    out = ops.sparse_gain(ids, mask)
    err = int((out[idx] - ref.sparse_gain(ids[idx], mask)).abs().max())
    check(err == 0, f"sparse_gain disagrees at scale ({route} route)")
    (c, m), w = ids.shape, mask.shape[0]
    b_ms, b_by = bound(4 * (c * m + w + c))
    return dict(name="sparse_gain", max_abs_err=err,
                ms=time_ms(lambda: ops.sparse_gain(ids, mask), 20),
                plain_ms=time_ms(lambda: ref.sparse_gain(ids, mask), 2),
                bound_ms=b_ms, bound_by=b_by, shape=[c, m, w], route_used=route,
                valid_ids=int((ids >= 0).sum()))


def xl_inputs(seed: int, dev=torch.device("cuda")):
    """solve_sparse_xl's own shapes, uncut: 2^20 sorted lists of up to 4096
    doc ids over 2^28 docs (16 GiB of ids, a 32 MiB covered bitset: the L2
    route), made on the card from `seed`; and 512 sampled rows."""
    gen = torch.Generator(dev).manual_seed(seed + 1)
    ids = torch.empty((XL_CLAUSES, SPARSE_M), dtype=torch.int32, device=dev)
    slot = torch.arange(SPARSE_M, device=dev)
    rows = min(2 ** 16, XL_CLAUSES)
    for r0 in range(0, XL_CLAUSES, rows):
        blk = torch.randint(0, XL_DOCS, (rows, SPARSE_M), dtype=torch.int32,
                            device=dev, generator=gen)
        blk = torch.sort(blk, dim=1).values
        lens = torch.randint(1, SPARSE_M + 1, (rows, 1), device=dev, generator=gen)
        ids[r0:r0 + rows] = torch.where(slot[None] < lens, blk, -1)
    mask = rand_words(gen, (XL_DOCS // 32,), dev)
    idx = torch.randperm(XL_CLAUSES, generator=gen, device=dev)[:512]
    torch.cuda.synchronize()
    return ids, mask, idx


def fold_ids(ids: torch.Tensor, docs: int, rows: int = 2 ** 16) -> None:
    """Fold every valid id into the first `docs` docs (a power of two), in
    place: the streamed bytes and the valid count stay, the mask words the
    ids reach shrink to docs / 32."""
    for r0 in range(0, ids.shape[0], rows):
        blk = ids[r0:r0 + rows]
        blk.copy_(torch.where(blk >= 0, blk & (docs - 1), blk))


def phase1_xl(seed: int, dev=torch.device("cuda")) -> dict:
    """sparse_gain at solve_sparse_xl's shapes (`xl_inputs`), then again
    with every valid id folded into 2^24 docs (a 2 MiB reach of the mask,
    resident in L2): the gap between the two is the cost of mask misses."""
    ids, mask, idx = xl_inputs(seed, dev)
    rec = sparse_record(ids, mask, idx, "l2")
    fold_ids(ids, XL_FOLD_DOCS)
    folded = sparse_record(ids, mask, idx, "l2")
    rec.update(folded_docs=XL_FOLD_DOCS, folded_ms=folded["ms"],
               folded_max_abs_err=folded["max_abs_err"])
    return rec


# -- phase 4: the LM serving path (gemma2-2b) on flash_attention --------------

BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
TF32_TC_FLOPS = 494.7e12       # H100 SXM dense TF32 tensor cores (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores (data sheet)
TF32_PER_F32 = 3               # TF32 products per f32-accurate product (split TF32)
PREFILL_B, PREFILL_S = 1, 32768          # registry prefill_32k: 32 x 32768
DECODE_B, DECODE_S = 8, 32768            # registry decode_32k: 128 x 32768
DECODE_STEPS = 4                         # timed steps, after one warm-up step
LM_REDUCED = {
    "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
    "decode_batch": "8 (decode_32k has 128, whose cache would be 446 GB); "
                    "cache length 32768 kept",
    "decode_steps": f"1 warm-up + {DECODE_STEPS} timed, at cur_len "
                    f"{DECODE_S - DECODE_STEPS - 1}..{DECODE_S - 1}",
    "weights": "random from --seed (init_params' distributions)",
}
BF16_TOL = 5e-2       # bf16 activations: a few 2^-8 ulps of values near 1
# the reference's flash-attention cases (tests/test_flash_attention.py) and
# ragged ones: both row tiles, every head dim, kv_len inside the cache; then
# rows that see no key (the window starts past the last valid key), alone,
# mixed with live rows in one tile, and kv_len 0; bf16 D = 256 row counts
# that are not a multiple of flash_prefill's 128, with q_offset > 0 and
# kv_len < Skv
FA_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len
    (1, 16, 16, 2, 1, 8, True, None, None, 0, None),
    (2, 32, 32, 4, 2, 16, True, None, None, 0, None),
    (1, 32, 32, 4, 4, 8, True, 8, None, 0, None),
    (1, 24, 24, 2, 1, 8, True, None, 20.0, 0, None),
    (1, 16, 16, 8, 2, 8, False, None, None, 0, None),
    (1, 1, 48, 4, 2, 8, True, None, None, 47, None),
    (1, 1, 48, 4, 2, 8, True, 16, 30.0, 40, None),
    (1, 20, 36, 2, 2, 8, True, None, None, 16, None),
    (1, 300, 300, 4, 2, 16, True, 100, 50.0, 0, None),
    (2, 257, 257, 8, 4, 32, True, 64, None, 0, None),
    (3, 129, 129, 16, 2, 64, True, None, 50.0, 0, None),
    (1, 77, 200, 6, 2, 128, False, None, None, 0, 150),
    (2, 5, 333, 8, 4, 256, True, 100, 50.0, 320, 325),
    (1, 200, 200, 2, 2, 8, True, 1, None, 0, None),
    (2, 1, 1000, 8, 4, 256, True, None, None, 999, None),
    (1, 8, 40, 4, 2, 64, True, 16, None, 500, 40),
    (1, 40, 300, 4, 2, 64, True, 8, None, 250, 260),
    (1, 64, 600, 8, 4, 256, True, 100, 50.0, 620, 560),
    (1, 30, 30, 4, 2, 64, True, None, None, 0, 0),
    (1, 20, 50, 4, 2, 128, True, None, 30.0, 10, 0),
    (1, 100, 400, 8, 4, 256, True, None, 50.0, 200, 280),
    (2, 70, 90, 4, 4, 128, False, 30, None, 5, 80),
]


def attention_pairs(sq: int, q_offset: int, kv_len: int, causal: bool = True,
                    window: int | None = None) -> int:
    """Unmasked (query, key) pairs of one query head."""
    p = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(p, max=kv_len - 1) if causal else torch.full_like(p, kv_len - 1)
    lo = (p - window + 1).clamp(min=0) if window is not None else torch.zeros_like(p)
    return int((hi - lo + 1).clamp(min=0).sum())


def fa_flops(q, causal, window, q_offset, kv_len) -> float:
    """4*D FLOPs per unmasked (query, key) pair and query head."""
    b, sq, hq, d = q.shape
    return 4.0 * d * attention_pairs(sq, q_offset, kv_len, causal, window) * b * hq


def fa_bound(q, k, causal, window, q_offset, kv_len) -> tuple[float, str]:
    """The least time (ms) of one flash_attention call and what sets it: the
    FLOPs (`fa_flops`) over the tensor-core peak for the operands' type
    (bf16: 989 TFLOP/s; f32: three TF32 products per f32-accurate product,
    as split TF32 computes it, over 494.7 TFLOP/s), or the bytes of q, the
    output and the unmasked K/V rows over HBM."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    flops = fa_flops(q, causal, window, q_offset, kv_len)
    live_keys = attention_pairs(1, q_offset, kv_len, causal, window) \
        if sq == 1 else kv_len
    nbytes = (2 * q.numel() + 2 * b * live_keys * hkv * d) * q.element_size()
    t_f = flops / BF16_TC_FLOPS if q.dtype == torch.bfloat16 \
        else TF32_PER_F32 * flops / TF32_TC_FLOPS
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase4_kernel_small(dev) -> dict:
    """flash_attention against its plain version on ragged shapes, f32
    (rtol = atol = 2e-4) and bf16 (2e-2, the reference's tolerances), keys
    at or past kv_len set to NaN (no kernel may read them). Each call
    launches the kernel `route` names, once: Sq = 1 flash_decode, bf16 with
    D in (64, 128, 256) flash_prefill, the rest the tile kernel; the
    outputs of flash_prefill and of the tile kernel are also held to their
    own plain versions `ref.flash_prefill` and `ref.flash_tile` at the same
    tolerances. Errors are kept per kernel and dtype, for the dtypes that
    kernel was given."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import route
    gen = torch.Generator(dev).manual_seed(13)
    worst = {k: {} for k in LM_KERNELS}
    want_launch = {k: 0 for k in LM_KERNELS}
    before = dict(_build.LAUNCHES)
    for case in FA_CASES:
        b, sq, skv, hq, hkv, d, causal, window, cap, qo, kvl = case
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        if kvl is not None:
            k[:, kvl:] = float("nan")
            v[:, kvl:] = float("nan")
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo, kv_len=kvl)
        for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            kn = route(qq, kk, vv)
            want_launch[kn] += 1
            got = ops.flash_attention(qq, kk, vv, **kw)
            wants = [ref.flash_attention(qq, kk, vv, **kw)]
            if kn == "flash_prefill":
                wants.append(ref.flash_prefill(qq, kk, vv, **kw))
            if kn == "flash_attention":
                wants.append(ref.flash_tile(qq, kk, vv, **kw))
            check(got.dtype == dt and bool(torch.isfinite(got).all()),
                  f"flash_attention {dt} not finite at {case}")
            for want in wants:
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                           msg=lambda m: f"{kn} {dt} {case}: {m}")
                name = "bf16" if dt == torch.bfloat16 else "f32"
                worst[kn][name] = max(worst[kn].get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    launched = {k: _build.LAUNCHES[k] - before[k] for k in LM_KERNELS}
    if dev.type == "cuda":
        check(launched == want_launch, f"ragged cases launched {launched}, "
              f"expected {want_launch}")
    log(f"[phase 4] flash_attention == plain on {len(FA_CASES)} ragged cases x 2 "
        f"dtypes (rows with no visible key, kv_len 0, NaN past kv_len among them; "
        f"flash_prefill also against ref.flash_prefill, the tile kernel against "
        f"ref.flash_tile): "
        + "; ".join(f"{k} max abs err " + ", ".join(f"{n} {e:.3g}" for n, e in w.items())
                    for k, w in worst.items() if w)
        + f" (2e-4 f32, 2e-2 bf16); launches {launched}")
    return worst


# ragged decode cases for flash_decode: every head dim, G = 1-16, 0 to 5000
# keys, windows and softcaps, B*Hkv from 1 to 140 (from one split to the
# plan's most for the length), rows padded to 8-byte alignment in bf16
# (`pad`), the no-visible-key edge and an empty cache
DECODE_CASES = [
    # b, hq, hkv, d, smax, kv_len, q_offset, causal, window, cap, pad
    (1, 1, 1, 8, 1, 1, 0, True, None, None, 0),
    (2, 4, 2, 16, 64, 37, 36, True, None, 30.0, 0),
    (1, 16, 1, 32, 3000, 3000, 2999, True, None, 50.0, 0),
    (3, 12, 4, 64, 2048, 1500, 1499, True, 512, None, 0),
    (33, 8, 4, 128, 700, 650, 649, True, None, None, 0),
    (70, 2, 2, 256, 300, 260, 259, True, 100, 50.0, 0),
    (1, 8, 1, 256, 4096, 4096, 4095, True, None, 50.0, 0),
    (2, 5, 1, 128, 2000, 1999, 1998, True, 1000, None, 0),
    (1, 1, 1, 64, 5000, 5000, 4999, True, None, 50.0, 0),
    (2, 8, 2, 16, 500, 400, 10, False, None, None, 0),
    (4, 16, 2, 8, 1024, 1024, 1023, True, 300, 50.0, 0),
    (2, 6, 2, 64, 256, 200, 199, True, 64, 30.0, 4),
    (2, 4, 2, 64, 100, 50, 120, True, 16, None, 0),
    (1, 2, 1, 32, 16, 0, 0, True, None, None, 0),
]


def row_error(got, want, bf16: bool, what: str) -> tuple[float, float]:
    """(largest |got - want| over its limit, max abs err), want from f32
    operands: each query position and batch row is held to 2e-4 x the rms
    of its own output, plus in bf16 the output's rounding, 2^-8 |want|.
    Raises past the limit."""
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    lim = 2e-4 * rms + (2.0 ** -8 * want.abs() if bf16 else 0.0)
    err = (got.float() - want).abs()
    ratio = float((err / lim.clamp(min=1e-30)).max())
    check(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
          f"{what}: error {ratio:.3g} x its limit (max abs err {float(err.max()):.3g})")
    return ratio, float(err.max())


def phase4_decode_small(dev) -> dict:
    """flash_decode (ops.flash_attention at Sq = 1) against its plain
    version on DECODE_CASES, in f32 and bf16: at the reference's tolerances
    against the plain version on the same operands, and each row within
    2e-4 x its rms (+ 2^-8 |want| in bf16) of the plain version on f32
    copies. Every call launches flash_decode once and flash_attention never."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_decode import launch_plan
    gen = torch.Generator(dev).manual_seed(17)
    worst = {"f32": 0.0, "bf16": 0.0, "abs": 0.0}
    splits = []
    before = dict(_build.LAUNCHES)
    for b, hq, hkv, d, smax, kvl, qo, causal, window, cap, pad in DECODE_CASES:
        q = torch.randn((b, 1, hq, d + pad), generator=gen, device=dev)[..., :d]
        k = torch.randn((2, b, smax, hkv, d + pad), generator=gen, device=dev)[1, ..., :d]
        v = torch.randn((2, b, smax, hkv, d + pad), generator=gen, device=dev)[1, ..., :d]
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo, kv_len=kvl)
        if dev.type == "cuda":
            splits.append(launch_plan(q, k, causal=causal, window=window,
                                      q_offset=qo, kv_len=kvl).n_splits)
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
        for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            what = f"flash_decode {dt} {(b, hq, hkv, d, smax, kvl, qo, causal, window, cap, pad)}"
            got = ops.flash_attention(qq, kk, vv, **kw)
            want = ref.flash_attention(qq, kk, vv, **kw)
            check(got.dtype == dt and got.shape == (b, 1, hq, d), f"{what}: {got.dtype} {got.shape}")
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what}: {m}")
            want_f = want32 if dt == torch.float32 else \
                ref.flash_attention(qq.float(), kk.float(), vv.float(), **kw)
            ratio, _ = row_error(got, want_f, dt == torch.bfloat16, what)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            worst[name] = max(worst[name], ratio)
            worst["abs"] = max(worst["abs"], float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    n = 2 * len(DECODE_CASES)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in LM_KERNELS}
    if dev.type == "cuda":
        check(launched == {"flash_attention": 0, "flash_decode": n, "flash_prefill": 0},
              f"ragged decode launched {launched}, expected flash_decode {n}")
    log(f"[phase 4] flash_decode == plain on {len(DECODE_CASES)} ragged decode "
        f"cases x 2 dtypes (splits {splits}): worst "
        f"error / limit f32 {worst['f32']:.3g}, bf16 {worst['bf16']:.3g}; max abs "
        f"err vs the plain version in the same dtype {worst['abs']:.3g} "
        f"(2e-4 f32, 2e-2 bf16); launches {launched}")
    return dict(worst, splits=splits)


def sdpa_call(q, k, v, causal: bool):
    """One scaled_dot_product_attention call on [B, H, S, D] copies of the
    operands (made here, not timed): the yardstick, never on the port's
    path. Returns (fn, out in [B, S, H, D])."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def fn():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    return fn, fn().transpose(1, 2)


_FLEX = {}


def sdpa_f32_record(q, k, v) -> dict:
    """The tile kernel and one scaled_dot_product_attention call in the
    setting SDPA computes (causal, no window, no softcap) on f32 operands:
    the memory-efficient backend forced, on [B, H, S, D] copies with K and
    V repeated to Hq (made here, not timed), since enable_gqa may send f32
    to the math backend (34 GB of scores at S = 32768). The yardstick, never
    on the port's path; held to the kernel at 2e-2 as flex_attention is.
    library_ms is None, and the refusal logged, if the backend does not
    take the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    s, g = q.shape[1], q.shape[2] // k.shape[2]
    b_ms, b_by = fa_bound(q, k, True, None, 0, s)
    got = ops.flash_attention(q, k, v)
    rec = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v), 3), bound_ms=b_ms,
               bound_by=b_by, shape=list(q.shape) + [s], library_ms=None,
               library_call="scaled_dot_product_attention, EFFICIENT_ATTENTION, "
                            "K/V repeated to Hq")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous() for x in (k, v))

    def fn():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    try:
        want = fn().transpose(1, 2)
    except RuntimeError as e:
        log(f"[phase 4] SDPA (memory-efficient backend) refused f32 {rec['shape']}: "
            f"{str(e).splitlines()[0]}; library time none")
        return rec
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, f32 prefill: {m}")
    rec.update(library_ms=time_ms(fn, 3), library_err=float((got - want).abs().max()))
    return rec


def flex_call(q, k, v, *, window, cap, q_offset=0, kv_len=None):
    """One compiled torch.nn.attention.flex_attention call that computes the
    kernel's function: the softcap as its score_mod, causal + window at
    q_offset as its block mask, on [B, H, S, D] copies of the first kv_len
    keys (made here, not timed). The library yardstick, never on the port's
    path. Returns (fn, out in [B, S, H, D])."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    kvl = k.shape[1] if kv_len is None else kv_len
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k[:, :kvl], v[:, :kvl]))

    def mask_mod(b, h, qi, ki):
        keep = qi + q_offset >= ki
        return keep & (qi + q_offset - ki < window) if window is not None else keep

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, None, None, q.shape[1], kvl, device=q.device)

    def fn():
        return _FLEX["fn"](qt, kt, vt, score_mod=score_mod if cap else None,
                           block_mask=mask, enable_gqa=True)
    return fn, fn().transpose(1, 2)


def fa_record(q, k, v, *, window, cap, q_offset=0, kv_len=None, reps=10,
              plain_reps=2) -> dict:
    """Time one model-shape flash_attention call beside its plain version
    (the routed kernel's: `ref.flash_prefill` for flash_prefill), one
    flex_attention call (held to the kernel at the reference's bf16
    tolerance) and its bound. `ms` is the median of back-to-back calls by
    CUDA events, which a short call's host work can set; so at decode
    (Sq = 1) `device_ms` is also the kernels' own time per call from a
    profiler trace, for the kernel and for flex_attention alike."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    kvl = k.shape[1] if kv_len is None else kv_len
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    b_ms, b_by = fa_bound(q, k, True, window, q_offset, kvl)
    plain = ref.flash_prefill if route(q, k, v) == "flash_prefill" else ref.flash_attention
    got = ops.flash_attention(q, k, v, **kw)
    t = time.perf_counter()
    lib, want = flex_call(q, k, v, window=window, cap=cap, q_offset=q_offset, kv_len=kv_len)
    compile_s = time.perf_counter() - t
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != flex_attention "
                               f"at {list(q.shape)} window={window} q_offset={q_offset}: {m}")
    rec = {}
    if q.shape[1] == 1:
        for key, fn in (("device_ms", lambda i: ops.flash_attention(q, k, v, **kw)),
                        ("library_device_ms", lambda i: lib())):
            got_ms = device_ms(fn, 10)
            rec[key] = None if got_ms is None else got_ms["busy"]
    return dict(rec, ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw), reps),
                plain_ms=time_ms(lambda: plain(q, k, v, **kw), plain_reps),
                library_ms=time_ms(lib, reps), library_call="flex_attention "
                "(torch.compile; softcap score_mod, causal+window block mask)",
                library_err=float((got.float() - want.float()).abs().max()),
                library_compile_s=compile_s,
                bound_ms=b_ms, bound_by=b_by, shape=list(q.shape) + [k.shape[1]],
                window=window, softcap=cap, q_offset=q_offset, kv_len=kvl)


def phase4_kernel_model(seed: int, dev) -> dict:
    """flash_attention at gemma2-2b's shapes (Hq 8, Hkv 4, D 256) against its
    plain version, in bf16 and on f32 copies of the same operands: prefill
    at S = 8192 and 32768 (window 4096 or none, softcap 50), bf16 on
    flash_prefill and f32 on the tile kernel, and decode (Sq = 1,
    flash_decode) against a strided slice of a layer-stacked
    32768-position cache. Then timed at the model's four settings, and the
    tile kernel at the prefill settings on the f32 copies (its route), with
    its bound in split TF32 and on the CUDA cores, and beside one f32 SDPA
    call in the setting SDPA computes.
    Errors are kept per kernel and dtype, for the dtypes routed to it."""
    from repro_torch.configs.gemma2_2b import CONFIG as cfg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.flash_decode import launch_plan
    gen = torch.Generator(dev).manual_seed(seed + 3)
    hq, hkv, d, win, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.local_window, cfg.attn_softcap
    bf = torch.bfloat16
    worst = {kn: {} for kn in LM_KERNELS}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf)

    def agree(q, k, v, what, rows=None, **kw):
        """The kernel on the bf16 operands and on f32 copies of them against
        the plain version on the f32 copies. Each query position is held to
        the size of its own output (a late row of a global layer is ~0.01):
        |err| <= 2e-4 * rms(row) in f32, and in bf16 that plus the output's
        rounding, 2^-8 * |want|. For each `rows` block (r0, n) the plain
        version runs on q[:, r0:r0+n] alone, at q_offset r0."""
        ops_in = {"f32": (q.float(), k.float(), v.float()), "bf16": (q, k, v)}
        outs = {name: ops.flash_attention(*x, **kw) for name, x in ops_in.items()}
        kernels = {name: route(*x) for name, x in ops_in.items()}
        for r0, n in rows or [(0, q.shape[1])]:
            kvl = kw.get("kv_len") or r0 + n
            want = ref.flash_attention(
                q[:, r0:r0 + n].float(), k[:, :kvl].float(), v[:, :kvl].float(),
                **dict(kw, q_offset=kw.get("q_offset", 0) + r0))
            for name, out in outs.items():
                wk = worst[kernels[name]]
                ratio, err = row_error(out[:, r0:r0 + n], want, name == "bf16",
                                       f"{kernels[name]} {name} {what} rows "
                                       f"{r0}..{r0 + n - 1}")
                wk[name] = max(wk.get(name, 0.0), ratio)
                wk["abs"] = max(wk.get("abs", 0.0), err)

    s = 8192
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    for w in (win, None):
        agree(q, k, v, f"prefill S={s} window={w}", window=w, softcap=cap)

    # decode: one layer's slice of a [2, B, Smax, Hkv, D] cache
    cache_k = rnd(2, DECODE_B, DECODE_S, hkv, d)
    cache_v = rnd(2, DECODE_B, DECODE_S, hkv, d)
    qd = rnd(DECODE_B, 1, hq, d)
    for cur in (0, 4095, 4096, DECODE_S - 1):
        for w in (win, None):
            agree(qd, cache_k[1], cache_v[1], f"decode cur_len={cur} window={w}",
                  window=w, softcap=cap, q_offset=cur, kv_len=cur + 1)

    # prefill S = 32768: the plain version on 512-query blocks
    s = PREFILL_S
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    for w in (win, None):
        agree(q, k, v, f"prefill S={s} window={w}", window=w, softcap=cap,
              rows=[(r, 512) for r in (0, 4096 - 256, s // 2 + 100, s - 512)])
    torch.cuda.synchronize()
    routed = {kn: sorted(n for n in wk if n != "abs") for kn, wk in worst.items()}
    check(routed == {"flash_attention": ["f32"], "flash_prefill": ["bf16"],
                     "flash_decode": ["bf16", "f32"]},
          f"gemma2-2b shapes took the routes {routed}")
    where = {"flash_attention": f"prefill 8192 and {PREFILL_S}",
             "flash_prefill": f"prefill 8192 and {PREFILL_S}",
             "flash_decode": f"decode at cur_len 0/4095/4096/{DECODE_S - 1}"}
    for kn, wk in worst.items():
        log(f"[phase 4] {kn} == plain at gemma2-2b shapes ({where[kn]}, window "
            f"{win} and global, softcap {cap}): worst error / limit "
            + ", ".join(f"{n} {wk[n]:.3g}" for n in routed[kn])
            + f" (limit 2e-4 x row rms, + 2^-8 |want| in bf16); max abs err "
            f"{wk['abs']:.3g}")

    rec = {"prefill_global": fa_record(q, k, v, window=None, cap=cap, reps=10,
                                       plain_reps=1),
           "prefill_local": fa_record(q, k, v, window=win, cap=cap, reps=20,
                                      plain_reps=1)}
    qf, kf, vf = q.float(), k.float(), v.float()
    tile = {name: fa_record(qf, kf, vf, window=w, cap=cap, reps=3, plain_reps=1)
            for name, w in (("prefill_global", None), ("prefill_local", win))}
    for name, w in (("prefill_global", None), ("prefill_local", win)):
        tile[name]["bound_cuda_core_ms"] = fa_flops(qf, True, w, 0, s) / FP32_FLOPS * 1e3
    tile["sdpa"] = sdpa_f32_record(qf, kf, vf)
    del qf, kf, vf
    cur = DECODE_S - 1
    for name, w in (("decode_global", None), ("decode_local", win)):
        rec[name] = fa_record(qd, cache_k[1], cache_v[1], window=w, cap=cap,
                              q_offset=cur, kv_len=cur + 1, reps=20)
        if dev.type == "cuda":
            rec[name]["n_splits"] = launch_plan(qd, cache_k[1], window=w, q_offset=cur,
                                                kv_len=cur + 1).n_splits

    # SDPA where one call computes the same function (no softcap, no
    # window); the kernel timed in that setting too
    lib = {}
    fn, want = sdpa_call(q, k, v, causal=True)
    got = ops.flash_attention(q, k, v)
    prefill_err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, prefill: {m}")
    b_ms, b_by = fa_bound(q, k, True, None, 0, s)
    lib["prefill"] = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v), 10),
                          library_ms=time_ms(fn, 5), bound_ms=b_ms, bound_by=b_by,
                          shape=list(q.shape) + [s], max_abs_err=prefill_err)
    kd, vd = cache_k[1][:, :cur + 1], cache_v[1][:, :cur + 1]
    fn, want = sdpa_call(qd, kd, vd, causal=False)   # one query sees every key
    kw = dict(q_offset=cur, kv_len=cur + 1)
    got = ops.flash_attention(qd, cache_k[1], cache_v[1], **kw)
    decode_err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, decode: {m}")
    b_ms, b_by = fa_bound(qd, cache_k[1], True, None, cur, cur + 1)
    lib["decode"] = dict(ms=time_ms(lambda: ops.flash_attention(qd, cache_k[1], cache_v[1], **kw), 20),
                         library_ms=time_ms(fn, 20), bound_ms=b_ms, bound_by=b_by,
                         shape=list(qd.shape) + [cur + 1], max_abs_err=decode_err)
    for name, r in list(rec.items()) + [(f"sdpa setting {n}", r) for n, r in lib.items()]:
        kn = "flash_decode" if "decode" in name else "flash_prefill"
        log(f"[phase 4] {kn} {name} {r['shape']}: {r['ms']:.3f} ms "
            + (f"(device {fmt_ms(r['device_ms'])}, flex_attention device "
               f"{fmt_ms(r['library_device_ms'])} by the profiler) " if "device_ms" in r else "")
            + f"(bound {r['bound_ms']:.3f} ms by {r['bound_by']}"
            + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
            + (f", flex_attention {r['library_ms']:.3f} ms (compiled in "
               f"{r['library_compile_s']:.1f}s, max abs diff {r['library_err']:.3g})"
               if "library_call" in r else f", SDPA {r['library_ms']:.3f} ms") + ")")
    for name in ("prefill_global", "prefill_local"):
        r = tile[name]
        log(f"[phase 4] flash_attention (tile kernel) {name} f32 {r['shape']}: "
            f"{r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by {r['bound_by']} in split "
            f"TF32, {r['bound_cuda_core_ms']:.3f} ms on the CUDA cores; plain "
            f"{r['plain_ms']:.3f} ms, flex_attention {r['library_ms']:.3f} ms "
            f"(compiled in {r['library_compile_s']:.1f}s, max abs diff "
            f"{r['library_err']:.3g}))")
    r = tile["sdpa"]
    log(f"[phase 4] flash_attention (tile kernel) sdpa setting f32 {r['shape']} "
        f"(causal, no window, no softcap): {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
        f"ms by {r['bound_by']}), SDPA memory-efficient {fmt_ms(r['library_ms'])}"
        + (f" (max abs diff {r['library_err']:.3g})" if r["library_ms"] is not None else ""))
    log(f"[phase 4] flash_prefill and flash_decode == SDPA in its setting: "
        f"max abs err prefill {prefill_err:.3g}, decode {decode_err:.3g} (bf16, 2e-2)")
    return dict(worst=worst, settings=rec, library=lib, tile=tile)


def decode_vs_forward(params, prompt, cfg, tol: float) -> float:
    """Teacher-force `prompt` [1, n] through decode_step: each step's logits
    equal forward's (with the final softcap) at that position."""
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    n = prompt.shape[1]
    h, _ = T.forward(params, prompt, cfg)
    full = common.softcap((h @ T.unembed_matrix(params, cfg).to(h.dtype)).float(),
                          cfg.final_softcap)
    cache = T.init_cache(cfg, 1, n, device=prompt.device)
    worst = 0.0
    for i in range(n):
        step, cache = T.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
        torch.testing.assert_close(step, full[:, i], rtol=tol, atol=tol,
                                   msg=lambda m: f"{cfg.name} {cfg.dtype} decode "
                                   f"step {i} != forward: {m}")
        worst = max(worst, float((step - full[:, i]).abs().max()))
    return worst


def card_vs_cpu(sp, cfg, gen, n_layers: int = 2, s: int = 256) -> dict:
    """The same full-width bf16 weights at `n_layers` layers over `s` tokens
    on the card and on the CPU: hidden states and lm_serve's last-token
    logits allclose at BF16_TOL; argmax tokens at every position equal except
    at near-ties (logit gap within 2 * BF16_TOL), which are logged."""
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    p2 = dict(sp, layers=T.tree_map(lambda a: a[:n_layers], sp["layers"]))
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=gen.device)
    out = {}
    for dev, p, tk in (("cuda", p2, toks),
                       ("cpu", T.tree_map(lambda a: a.cpu(), p2), toks.cpu())):
        t = time.perf_counter()
        h, _ = T.forward(p, tk, cfg2)
        # lm_serve's prefill logits (the last token's, in bf16), and every
        # position's in f32 from the bf16 hidden states
        last = h[:, -1, :] @ T.unembed_matrix(p, cfg2).to(h.dtype)
        logits = h[0].float() @ T.unembed_matrix(p, cfg2).float()
        out[dev] = (h.cpu().float(), last.cpu().float(), logits.cpu())
        log(f"[phase 4] {n_layers}-layer gemma2-2b over {s} tokens on {dev}: "
            f"{time.perf_counter() - t:.1f}s")
    (hg, lg, ag), (hc, lc, ac) = out["cuda"], out["cpu"]
    for what, g, c in (("hidden states", hg, hc), ("last-token logits", lg, lc)):
        torch.testing.assert_close(g, c, rtol=BF16_TOL, atol=BF16_TOL,
                                   msg=lambda m: f"card != CPU, {what}: {m}")
    top_g, top_c = ag.argmax(-1), ac.argmax(-1)
    differ = torch.nonzero(top_g != top_c)[:, 0].tolist()
    ties = []
    for i in differ:
        a, b = int(top_g[i]), int(top_c[i])
        gap = max(abs(float(ag[i, a] - ag[i, b])), abs(float(ac[i, a] - ac[i, b])))
        check(gap <= 2 * BF16_TOL, f"card and CPU argmax differ at position {i} "
              f"({a} vs {b}) with logit gap {gap}")
        ties.append((i, a, b, gap))
    res = dict(hidden_err=float((hg - hc).abs().max()),
               logits_err=float((lg - lc).abs().max()), argmax_near_ties=ties)
    log(f"[phase 4] card == CPU at {n_layers} layers, {s} tokens: hidden max abs "
        f"err {res['hidden_err']:.3g}, last-token logits {res['logits_err']:.3g} "
        f"(bf16, {BF16_TOL}); argmax equal at {s - len(ties)} of {s} positions, "
        f"near-ties {ties}")
    return res


def device_ms(fn, n: int) -> dict | None:
    """Per call of fn(i), i < n, from a torch.profiler trace of the n calls:
    the device time of every kernel (they run one at a time on the one
    stream, so this is the device's busy time) and of each LM kernel's.
    None (not measured) when two traces in a row hold no kernel: after many
    sessions in one process the profiler has returned empty traces."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        if busy > 0:
            out = {"busy": busy}
            for k in LM_KERNELS:
                out[k] = sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3 / n
            return out
    log("[phase 4] the profiler saw no device time: not measured")
    return None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def busy_share(part: dict | None, kernel: str, wall_ms: float) -> str:
    """The device's busy time and a kernel's share of it, for a log line."""
    if part is None:
        return "device busy time not measured"
    return (f"device busy {part['busy']:.3f} ms (idle {1 - part['busy'] / wall_ms:.1%} "
            f"of {wall_ms:.3f} ms); {kernel} {part[kernel]:.3f} ms "
            f"({part[kernel] / part['busy']:.1%} of busy)")


def phase4_model(seed: int, dev) -> dict:
    """gemma2-2b at full width and depth through lm_serve: decode matches
    forward (f32 and bf16), card matches CPU at 2 layers, then prefill
    B=1 x 32768 and decode steps at B=8 against a 32768-position cache."""
    from repro_torch.configs import registry
    from repro_torch.configs.gemma2_2b import CONFIG as cfg
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    res: dict = {"reduced": LM_REDUCED}
    gen = torch.Generator(dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    log(f"[phase 4] gemma2-2b: {cfg.param_count()} parameters made on the card "
        f"in {time.perf_counter() - t:.1f}s; reduced {json.dumps(LM_REDUCED)}")

    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen, device=dev)
    t = time.perf_counter()
    # the f32 path: forward's Sq = 64 attention on the tile kernel, then the
    # decode steps on flash_decode
    _build.reset_launches()
    res["decode_vs_forward_f32"] = decode_vs_forward(
        params, prompt, dataclasses.replace(cfg, dtype="float32"), 1e-3)
    launches = dict(_build.LAUNCHES)
    n = prompt.shape[1]
    check(launches["flash_attention"] == cfg.n_layers and launches["flash_prefill"] == 0
          and launches["flash_decode"] == cfg.n_layers * n,
          f"the f32 forward and decode launched {launches}")
    res["f32_path_launches"] = launches["flash_attention"]
    sp = T.serving_params(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["decode_vs_forward_bf16"] = decode_vs_forward(sp, prompt, cfg, BF16_TOL)
    log(f"[phase 4] decode_step == forward over a 64-token prompt at full "
        f"width and depth: max abs logit err f32 {res['decode_vs_forward_f32']:.3g} "
        f"(1e-3), bf16 {res['decode_vs_forward_bf16']:.3g} ({BF16_TOL}); "
        f"{time.perf_counter() - t:.1f}s")
    res["card_vs_cpu"] = card_vs_cpu(sp, cfg, gen)

    # the main path: prefill, then decode steps, each run's launches counted
    prefill = registry.lm_serve(cfg, "prefill_32k")
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prefill(sp, {"tokens": toks})                    # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    logits = prefill(sp, {"tokens": toks})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    check(launches["flash_prefill"] == cfg.n_layers and launches["flash_attention"] == 0
          and launches["flash_decode"] == 0,
          f"prefill launched flash_prefill {launches['flash_prefill']}, the tile "
          f"kernel {launches['flash_attention']} and flash_decode "
          f"{launches['flash_decode']} times")
    check(logits.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    res["prefill"] = dict(s=dt, tokens_per_s=PREFILL_B * PREFILL_S / dt,
                          launches=launches["flash_prefill"])
    log(f"[phase 4] prefill B={PREFILL_B} S={PREFILL_S}: {dt * 1e3:.1f} ms, "
        f"{res['prefill']['tokens_per_s']:.1f} tokens/s; launches {launches}")
    res["prefill"]["device_ms"] = device_ms(lambda i: prefill(sp, {"tokens": toks}), 1)
    log(f"[phase 4] prefill under torch.profiler: "
        + busy_share(res["prefill"]["device_ms"], "flash_prefill", dt * 1e3))
    del logits
    torch.cuda.empty_cache()

    decode = registry.lm_serve(cfg, "decode_32k")
    t = time.perf_counter()
    cache = T.init_cache(cfg, DECODE_B, DECODE_S, device=dev)
    for key in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[key][i].normal_(generator=gen)
    torch.cuda.synchronize()
    log(f"[phase 4] decode cache {tuple(cache['k'].shape)} x2 "
        f"({2 * cache['k'].numel() * 2 / 2 ** 30:.1f} GiB) filled in "
        f"{time.perf_counter() - t:.1f}s")
    tok = torch.randint(0, cfg.vocab_size, (DECODE_B, 1), generator=gen, device=dev)
    start = DECODE_S - DECODE_STEPS - 1
    decode(sp, {"cache": cache, "tokens": tok, "cur_len": start})     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    steps = []
    for cur in range(start + 1, DECODE_S):
        t = time.perf_counter()
        logits, cache = decode(sp, {"cache": cache, "tokens": tok, "cur_len": cur})
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        check(logits.shape == (DECODE_B, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"decode logits at {cur} not finite")
        tok = logits.argmax(-1, keepdim=True)
    launches = dict(_build.LAUNCHES)
    check(launches["flash_decode"] == cfg.n_layers * DECODE_STEPS
          and launches["flash_attention"] == 0 and launches["flash_prefill"] == 0,
          f"decode launched flash_decode {launches['flash_decode']}, the tile "
          f"kernel {launches['flash_attention']} and flash_prefill "
          f"{launches['flash_prefill']} times")
    res["decode"] = dict(ms_per_step=statistics.median(steps), steps_ms=steps,
                         launches=launches["flash_decode"])
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[phase 4] decode B={DECODE_B} against a {DECODE_S}-position cache: "
        f"{res['decode']['ms_per_step']:.3f} ms per step (median; steps {steps}); "
        f"launches {launches}; max_memory_allocated {res['peak_gib']:.2f} GiB")
    # two more steps over the last two positions again, traced
    prof = device_ms(lambda i: decode(sp, {"cache": cache, "tokens": tok,
                                           "cur_len": DECODE_S - 2 + i}), 2)
    res["decode"]["device_ms"] = prof
    log(f"[phase 4] decode under torch.profiler, per step: "
        + busy_share(prof, "flash_decode", res["decode"]["ms_per_step"]))
    return res


def lm_record(kern: dict, model: dict, small: dict, cfg, fa_small: dict) -> list[dict]:
    """The LM kernels' entries of the kernels line. flash_prefill: prefill
    at S = 32768 on a global layer (softcap 50) is its headline setting,
    the local layer and the SDPA yardstick ride along, with its own work
    floor (1.5x the bound: P·V twice). flash_attention (the tile kernel):
    the same two settings on f32 copies of the operands (its route), the
    f32 SDPA yardstick, and its launches on the f32 path. flash_decode: decode at B = 8 against cur_len 32767 on a
    global layer, with the local layer, SDPA and the plan's splits. `small`
    holds flash_decode's ragged errors, `fa_small` the ragged errors of the
    Sq > 1 kernels."""
    st = kern["settings"]
    n_glob = sum(cfg.is_global_layer())
    n_loc = cfg.n_layers - n_glob
    attn_prefill = n_glob * st["prefill_global"]["ms"] + n_loc * st["prefill_local"]["ms"]
    attn_decode = n_glob * st["decode_global"]["ms"] + n_loc * st["decode_local"]["ms"]
    prefill_ms = model["prefill"]["s"] * 1e3
    decode_ms = model["decode"]["ms_per_step"]
    recs = []
    for name, head, other, lib, launches, lm in (
            ("flash_prefill", "prefill_global", "prefill_local", "prefill",
             model["prefill"]["launches"],
             dict(prefill_tokens_per_s=model["prefill"]["tokens_per_s"],
                  prefill_ms=prefill_ms,
                  attention_share_prefill=attn_prefill / prefill_ms,
                  prefill_device_ms=model["prefill"]["device_ms"])),
            ("flash_decode", "decode_global", "decode_local", "decode",
             model["decode"]["launches"],
             dict(decode_ms_per_step=decode_ms,
                  attention_share_decode=attn_decode / decode_ms,
                  decode_device_ms_per_step=model["decode"]["device_ms"]))):
        wk = kern["worst"][name]
        r = dict(st[head])
        r.update(name=name, max_abs_err=wk["abs"], settings={other: st[other]},
                 err_over_limit={k: e for k, e in wk.items() if k != "abs"},
                 library_setting=kern["library"][lib], launches=launches,
                 lm=dict(lm, reduced=model["reduced"]))
        if name == "flash_decode":
            r["max_abs_err"] = max(wk["abs"], small["abs"])
            r["err_over_limit_ragged"] = {k: small[k] for k in ("f32", "bf16")}
            r["ragged_splits"] = small["splits"]
        else:
            r["max_abs_err"] = max(wk["abs"], *fa_small[name].values())
            r["work_floor_ms"] = 1.5 * r["bound_ms"]
            r["library_sdpa_ms"] = kern["library"][lib]["library_ms"]
        recs.append(r)
    # the tile kernel: its route is f32 (and what flash_prefill does not take)
    tile = kern["tile"]
    wk = kern["worst"]["flash_attention"]
    r = dict(tile["prefill_global"])
    r.update(name="flash_attention", settings={"prefill_local": tile["prefill_local"]},
             library_setting=tile["sdpa"], library_sdpa_ms=tile["sdpa"]["library_ms"],
             max_abs_err=max(wk["abs"], *fa_small["flash_attention"].values()),
             err_over_limit={k: e for k, e in wk.items() if k != "abs"},
             launches=model["f32_path_launches"],
             launches_path="the f32 forward of decode_step == forward (64 tokens, "
                           "26 layers); 0 in the bf16 prefill")
    recs.insert(1, r)
    log(f"[phase 4] attention share: prefill {attn_prefill:.1f} of {prefill_ms:.1f} ms "
        f"({attn_prefill / prefill_ms:.1%}), decode {attn_decode:.3f} of "
        f"{decode_ms:.3f} ms ({attn_decode / decode_ms:.1%}) ({n_glob} global and "
        f"{n_loc} local layers at the timed settings' kernel times)")
    return recs


SOURCES = {
    "coverage_gain": ("src/repro_torch/kernels/csrc/coverage_gain.cu",
                      "src/repro/kernels/coverage_gain.py:33"),
    "bit_matvec": ("src/repro_torch/kernels/csrc/bit_matvec.cu",
                   "src/repro/kernels/bit_matvec.py:80"),
    "clause_match": ("src/repro_torch/kernels/csrc/clause_match.cu",
                     "src/repro/kernels/clause_match.py:67"),
    "tier_match": ("src/repro_torch/kernels/csrc/tier_match.cu",
                   "src/repro/kernels/fused_match.py:80"),
    "partition_gain": ("src/repro_torch/kernels/csrc/partition_gain.cu",
                       "src/repro/kernels/partition_gain.py:57"),
    "sparse_gain": ("src/repro_torch/kernels/csrc/sparse_gain.cu",
                    "src/repro/kernels/sparse_gain.py:41"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention.py:93"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention.py:93"),
}
# the kernels of the tiering paths (phases 1-3); the LM phase checks its own
LM_KERNELS = ("flash_attention", "flash_decode", "flash_prefill")
TIERING_KERNELS = tuple(k for k in SOURCES if k not in LM_KERNELS)


def ptxas_lines(build_log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output: its
    (mangled) name, spills and registers."""
    out, name, spill = [], "?", ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {spill}; {ln.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # flex_attention's compiled yardstick keeps its caches in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / sub))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # no TF32 in any matmul
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    t_all = time.perf_counter()

    t = time.perf_counter()
    card = card_line()
    log(f"[phase 0] card: {card}")
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build.lib()
    ptxas = ptxas_lines(_build.build_info["log"])
    log(f"[phase 0] kernels built in {_build.build_info['seconds']:.1f}s "
        f"-> {_build.build_info['path']}")
    for ln in ptxas:
        log(f"[phase 0]   ptxas {ln}")
    log(f"[phase 0] {time.perf_counter() - t:.1f}s")

    rec = tiering_phases(args.seed)
    t = time.perf_counter()
    fa_small = phase4_kernel_small(cuda)
    small = phase4_decode_small(cuda)
    kern = phase4_kernel_model(args.seed, cuda)
    gc.collect()
    torch.cuda.empty_cache()
    model = phase4_model(args.seed, cuda)
    from repro_torch.configs.gemma2_2b import CONFIG
    for r in lm_record(kern, model, small, CONFIG, fa_small):
        src, tpu = SOURCES[r["name"]]
        r.update(route="cuda", source=src, replaces=tpu)
        rec.append(r)
    log(f"[phase 4] {time.perf_counter() - t:.1f}s")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": rec}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def tiering_phases(seed: int) -> list[dict]:
    """Phases 1-3 and the tiering kernels' records."""
    t = time.perf_counter()
    worst = phase1_small(torch.device("cuda"))
    log(f"[phase 1] ragged shapes: integer kernels equal, bit_matvec max abs "
        f"err {worst:.3g} (rtol 1e-5, atol 1e-4); "
        f"{time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    medium_counts: dict = {}
    medium = phase2(medium_counts)["data"]
    log(f"[phase 2] {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    counts: dict = {}
    p3 = phase3(seed, counts)
    p3["shards"] = phase3_shards(p3, counts)
    p3["sparse"] = phase3_sparse(p3, counts)
    check(all(counts[k] > 0 for k in TIERING_KERNELS) and len(counts) == len(SOURCES)
          and all(counts[k] == 0 for k in LM_KERNELS),
          f"a kernel never launched in phase 3, or an LM kernel did: {counts}")
    log(f"[phase 3] launches {dict(counts)}; {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    solvers = phase3_solvers(p3)
    telemetry = phase3_telemetry(p3)
    log(f"[phase 3] other solvers and telemetry: {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    from repro_torch import obs
    plane = obs.set_enabled(False)     # kernel timings as before the plane
    rec = phase1_scale(p3)
    obs.set_enabled(plane)
    t_scale = time.perf_counter() - t
    shards = p3["shards"]

    p5 = phase5(p3, medium)
    del p3, medium               # free the production operands
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    plane = obs.set_enabled(False)
    xl = phase1_xl(seed)
    log(f"[phase 1] at scale sparse_gain {xl['shape']} (solve_sparse_xl, L2 "
        f"route): {xl['ms']:.3f} ms (bound {xl['bound_ms']:.3f} ms by "
        f"{xl['bound_by']}, plain {xl['plain_ms']:.3f} ms), max abs err "
        f"{xl['max_abs_err']}; ids folded into {xl['folded_docs']} docs "
        f"{xl['folded_ms']:.3f} ms, max abs err {xl['folded_max_abs_err']}")
    next(r for r in rec if r["name"] == "sparse_gain")["l2_route"] = xl
    obs.set_enabled(plane)
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 3] per-shard per-selection ms (median): "
        f"{json.dumps(shards['per_selection_ms'])}")
    for r in rec:
        src, tpu = SOURCES[r["name"]]
        r.update(route="cuda", source=src, replaces=tpu,
                 launches=counts[r["name"]],
                 launches_medium=medium_counts[r["name"]], library_ms=None,
                 launches_solvers={n: v["launches"].get(r["name"], 0)
                                   for n, v in solvers.items()
                                   if isinstance(v, dict) and "launches" in v},
                 launches_phase5={path: n.get(r["name"], 0)
                                  for path, n in p5.items()})
        prof = [x for x in telemetry["rows"] if x["op"] == r["name"]]
        if prof:
            r["profiler"] = prof[0]
        dev = f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
        log(f"[phase 1] at scale {r['name']} {r['shape']}: {r['ms']:.3f} ms{dev} "
            f"(bound {r['bound_ms']:.3f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.3f} ms), max abs err {r['max_abs_err']:.3g}")
    cx = next(r for r in rec if r["name"] == "clause_match")["serve_route_k"]
    log(f"[phase 1] at scale clause_match {cx['shape']} (serve_route's K): "
        f"{cx['ms']:.3f} ms (device {cx['device_ms']:.4f} ms), "
        f"{cx['ms_permuted']:.3f} ms under a vocabulary permutation (bound "
        f"{cx['bound_ms']:.3f} ms by {cx['bound_by']}, plain {cx['plain_ms']:.3f} ms on {cx['plain_queries']} queries); "
        f"fused_match {cx['fused_match_ms']:.3f} ms; {cx['eligible']:.4f} "
        f"eligible; max abs err {cx['max_abs_err']}")
    log(f"[phase 1] at scale: {t_scale + time.perf_counter() - t:.1f}s")
    return rec


def phase5(p3: dict, medium) -> dict:
    """Phase 5 a-d; returns each path's launches. Frees phase 3's clause
    bitsets and its engine's Tier-1 copy before the fleet is built."""
    t_all = time.perf_counter()
    procs = start_launchers(Path(__file__).resolve().parent)
    try:
        t = time.perf_counter()
        gpu = phase5_medium(medium)
        log(f"[phase 5] a: {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        finish_launchers(procs)
        log(f"[phase 5] d: waited {time.perf_counter() - t:.1f}s for the "
            f"launchers (started with a)")
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t = time.perf_counter()
    prod = phase5_production(p3)
    log(f"[phase 5] b: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    postings, n_docs = p3["engine"].postings_t2, p3["problem"].n_docs
    for k in ("problem", "engine", "state", "greedy", "sparse", "qbits"):
        p3.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fleet = phase5_fleet(postings, n_docs, prod)
    log(f"[phase 5] c: {time.perf_counter() - t:.1f}s; phase 5 "
        f"{time.perf_counter() - t_all:.1f}s")
    return {"stream_medium": gpu["launches"]["engine"],
            "fleet_medium": gpu["launches"]["fleet"],
            "stream_production": prod["launches"],
            "fleet_production": fleet["launches"]}


if __name__ == "__main__":
    sys.exit(main())
