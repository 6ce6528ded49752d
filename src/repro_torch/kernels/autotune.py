"""Seeded, deterministic block-size autotuner for the CUDA gain kernels.

The port's counterpart of `repro.kernels.autotune`. Every tunable kernel
dispatch in `ops.py` resolves its tile through `ExecutionPlan.tile_params`,
which lands here: the call shape is rounded to a power-of-two bucket
(`tiles.pow2_bucket`) and looked up in a persisted JSON cache keyed
``"{op}|{path}|{bucket}"``, path being where the operands lie (`ops.path_of`:
"cuda"). A hit passes the tile to the kernel's wrapper as a keyword: the
warps per block of `coverage_gain`, `bit_matvec` and `partition_gain` (one
row a warp, the counterpart of Pallas's `block_c`; on the split route, which
one-row buckets take, the warps of each CTA of a row's cluster; 8 by
default), the
queries per block of `clause_match`'s pass B (`qpb`, the counterpart of
`block_b`; `clause_match.plan`'s pick by default). A miss keeps the
defaults, so the cache is a pure speed overlay: a pick never changes a
result. A value outside an op's space, or a `qpb` whose shared memory does
not fit the call, raises in the wrapper; nothing is quietly replaced.

Cache resolution order:

- ``REPRO_TORCH_KERNEL_TILES=0|off|none|false`` → autotuning disabled.
- ``REPRO_TORCH_KERNEL_TILES=/path.json``      → explicit cache file.
- unset                                       → ``artifacts/autotune/tiles_torch.json``.

The variable names a cache file and nothing else: the operands' device
still picks the route. The port keeps its own file and variable because
`search` rewrites its whole file, so a file shared with the reference's
tuner would let either package wipe the other's entries.

The search (`search` / `ensure_cache`, also ``python -m
repro_torch.kernels.autotune``) times the CUDA kernels and runs only on a
card; the plain versions have no blocks, so there is nothing to tune on the
CPU. It is deterministic by construction: data is synthesized from a fixed
seed (the reference's numpy draws), candidates are enumerated in a fixed
order, every candidate's output must be bit-equal to the default's, timing
is interleaved round robin (each trial one replay of a CUDA graph of the
call between two CUDA events) with a median reduce, and ties go to the
earlier candidate, the default call first: a bucket where no candidate
beats it keeps the default. The picks are machine-dependent by design, which is why
the cache lives under the gitignored ``artifacts/`` tree.
"""
from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

from repro_torch.kernels.clause_match import QPB
from repro_torch.kernels.clause_match import fits as _qpb_fits
from repro_torch.kernels.tiles import WARPS, WORD, pow2_bucket

ENV_VAR = "REPRO_TORCH_KERNEL_TILES"
DEFAULT_CACHE = os.path.join("artifacts", "autotune", "tiles_torch.json")
_DISABLED = ("0", "off", "none", "false")
CACHE_VERSION = 1

# ---------------------------------------------------------------------------
# Candidate spaces, keyed (op, path) with the path `ops.path_of` gives. Only
# the ops the reference tunes; `sparse_gain`, `tier_match` and the attention
# kernels keep their own plans. No "cpu" space: the plain versions have no
# blocks.
# ---------------------------------------------------------------------------

_WARPS = [{"warps": w} for w in WARPS]

SPACES: Dict[Tuple[str, str], List[Dict[str, Any]]] = {
    ("coverage_gain", "cuda"): _WARPS,
    ("bit_matvec", "cuda"): _WARPS,
    ("partition_gain", "cuda"): _WARPS,
    ("clause_match", "cuda"): [{"qpb": q} for q in QPB],
}


@functools.lru_cache(maxsize=4096)
def bucket(op: str, *dims: int) -> str:
    """Canonical bucket string for an op's characteristic dims (pow2-rounded;
    memoised: dispatch asks on every call)."""
    names = {
        "clause_match": ("b", "k", "w"),
        "bit_matvec": ("c", "w", "r"),
        "coverage_gain": ("c", "w"),
        "partition_gain": ("c", "w", "p"),
        "fused_match": ("b", "l", "w"),
    }[op]
    return "_".join(f"{n}{pow2_bucket(max(1, d))}" for n, d in zip(names, dims))


def bucket_from_args(op: str, args: Sequence[Any]):
    """Derive the shape bucket from the positional args `ops._run` sees.

    Returns None for ops with no tunable space (dispatch then skips the
    cache lookup entirely). `partition_gain` buckets in `ops.partition_gain`,
    which knows its partition count.
    """
    if op == "clause_match":
        q, c = args[0], args[1]
        return bucket(op, q.shape[0], c.shape[0], q.shape[1])
    if op == "bit_matvec":
        a, x = args[0], args[1]
        r = x.shape[1] if x.ndim > 1 else 1
        return bucket(op, a.shape[0], a.shape[1], r)
    if op == "coverage_gain":
        a = args[0]
        return bucket(op, a.shape[0], a.shape[1])
    return None


# ---------------------------------------------------------------------------
# Cache lookup (hot path: memoised on the variable's value, so a test
# flipping it by monkeypatch invalidates naturally; call `invalidate()`
# after rewriting the cache file in place).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _load_entries(path: str) -> Dict[str, Dict[str, Any]]:
    try:
        with open(path) as fh:
            blob = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
        return {}
    entries = blob.get("entries", {})
    return entries if isinstance(entries, dict) else {}


@functools.lru_cache(maxsize=4096)
def _tile_params_cached(env_raw, op: str, path: str, shape_bucket: str):
    if env_raw is not None and env_raw.strip().lower() in _DISABLED:
        return {}
    cache_path = env_raw if env_raw else DEFAULT_CACHE
    got = _load_entries(cache_path).get(f"{op}|{path}|{shape_bucket}")
    if not isinstance(got, dict):
        return {}
    # drop bookkeeping keys; whatever remains is the wrapper's keywords
    return {k: v for k, v in got.items() if not k.startswith("_")}


def tile_params(op: str, path: str, shape_bucket) -> Dict[str, Any]:
    """Tuned keywords for (op, path, bucket); {} on a miss or when disabled."""
    if shape_bucket is None:
        return {}
    return dict(_tile_params_cached(os.environ.get(ENV_VAR), op, path, shape_bucket))


def invalidate() -> None:
    """Drop memoised cache state (after rewriting the cache file in place)."""
    _load_entries.cache_clear()
    _tile_params_cached.cache_clear()


def cache_path() -> str:
    raw = os.environ.get(ENV_VAR)
    if raw and raw.strip().lower() not in _DISABLED:
        return raw
    return DEFAULT_CACHE


# ---------------------------------------------------------------------------
# Search.
# ---------------------------------------------------------------------------

# `data/synthetic.py`'s `medium` preset (20000 docs, a 2000-term vocabulary,
# a pool of 30000 distinct queries) mined at min_support 1e-3: 1023 clauses
MEDIUM_CLAUSES = 1023
MEDIUM_DOC_WORDS = -(-20000 // WORD)       # 625
MEDIUM_QUERY_WORDS = -(-30000 // WORD)     # 938: at most the pool's queries
MEDIUM_VOCAB_WORDS = -(-2000 // WORD)      # 63
MEDIUM_SHARDS, MEDIUM_BATCH = 4, 128       # per-shard caps, serve batch
# the production shapes the card runs (`chip_smoke.py` phase 3: 2^16
# clauses, 2^20 docs and queries, a 2^17-term vocabulary, 8 shard caps,
# 4096-query serve batches, optpes refreshing 4096 rows)
PROD_CLAUSES, PROD_WORDS, PROD_VOCAB_WORDS = 2 ** 16, 2 ** 15, 2 ** 12
PROD_SHARDS, PROD_BATCH, PROD_REFRESH = 8, 4096, 4096

# Default tuning workload: the shapes the port runs on the card.
# (op, path, dims).
DEFAULT_WORKLOAD: List[Tuple[str, str, Tuple[int, ...]]] = [
    # production: a greedy step over every clause, optpes's refreshed rows,
    # the per-shard g-gains, ψ of a serve batch against the deployed 128
    # clauses and against serve_route's 2^16 candidates
    ("coverage_gain", "cuda", (PROD_CLAUSES, PROD_WORDS)),
    ("bit_matvec", "cuda", (PROD_CLAUSES, PROD_WORDS, 1)),
    ("partition_gain", "cuda", (PROD_CLAUSES, PROD_WORDS, PROD_SHARDS)),
    ("coverage_gain", "cuda", (PROD_REFRESH, PROD_WORDS)),
    ("bit_matvec", "cuda", (PROD_REFRESH, PROD_WORDS, 1)),
    ("clause_match", "cuda", (PROD_BATCH, 128, PROD_VOCAB_WORDS)),
    ("clause_match", "cuda", (PROD_BATCH, PROD_CLAUSES, PROD_VOCAB_WORDS)),
    # the one-row evaluations of lazy, agnostic and ingest's offers (lazy's
    # under per-shard caps: partition_gain), each timed on the route its
    # shape picks (`tiles.gain_route`: the split route at this width)
    ("coverage_gain", "cuda", (1, PROD_WORDS)),
    ("bit_matvec", "cuda", (1, PROD_WORDS, 1)),
    ("partition_gain", "cuda", (1, PROD_WORDS, PROD_SHARDS)),
    # `medium`
    ("coverage_gain", "cuda", (MEDIUM_CLAUSES, MEDIUM_DOC_WORDS)),
    ("bit_matvec", "cuda", (MEDIUM_CLAUSES, MEDIUM_QUERY_WORDS, 1)),
    ("partition_gain", "cuda", (MEDIUM_CLAUSES, MEDIUM_DOC_WORDS, MEDIUM_SHARDS)),
    ("clause_match", "cuda", (MEDIUM_BATCH, MEDIUM_CLAUSES, MEDIUM_VOCAB_WORDS)),
    ("coverage_gain", "cuda", (1, MEDIUM_DOC_WORDS)),
    ("bit_matvec", "cuda", (1, MEDIUM_QUERY_WORDS, 1)),
    ("partition_gain", "cuda", (1, MEDIUM_DOC_WORDS, MEDIUM_SHARDS)),
]


def _rows(rng, seed: int, c: int, w: int, memo: dict | None):
    """The first draw of the gain ops' operands from a fresh generator,
    uniform words [C, W]. `memo` (one search's) keeps it and the
    generator's state after it: the next op of the same (seed, C, W) gets
    the same words and draws on from the same state without drawing them
    again (8 GiB at the production shape)."""
    import numpy as np

    rows = memo.setdefault("rows", {}) if memo is not None else {}
    if (seed, c, w) in rows:
        a, state = rows[(seed, c, w)]
        rng.bit_generator.state = state
        return a
    a = rng.integers(0, 1 << 32, size=(c, w), dtype=np.uint32)
    rows[(seed, c, w)] = (a, rng.bit_generator.state)
    return a


def _synth(op: str, dims: Tuple[int, ...], seed: int, memo: dict | None = None):
    """The reference's synthetic operands (the same numpy draws from the
    same seed), as uint32 / f32 arrays. One difference: `partition_gain`'s
    bounds are P+1 word offsets over the W words, as the kernel takes them;
    the reference spaces them over the C rows, which only a square shape
    makes valid word offsets (its default workload tunes no partition_gain)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if op == "clause_match":
        b, k, wv = dims
        q = rng.integers(0, 1 << 32, size=(b, wv), dtype=np.uint32)
        c = (
            rng.integers(0, 1 << 32, size=(k, wv), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(k, wv), dtype=np.uint32)
            & rng.integers(0, 1 << 32, size=(k, wv), dtype=np.uint32)
        )
        hits = max(1, min(b, k) // 4)  # force some real subset matches
        c[:hits] &= q[:hits]
        return (q, c)
    if op == "bit_matvec":
        c, w, r = dims
        a = _rows(rng, seed, c, w, memo)
        x = rng.standard_normal((w * 32, r), dtype=np.float32)
        return (a, x)
    if op == "coverage_gain":
        c, w = dims
        a = _rows(rng, seed, c, w, memo)
        m = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint32)
        return (a, m)
    if op == "partition_gain":
        c, w, p = dims
        a = _rows(rng, seed, c, w, memo)
        m = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint32)
        bounds = tuple(int(v) for v in np.linspace(0, w, p + 1).astype(int))
        return (a, m, bounds)
    raise ValueError(f"no synthetic workload for op {op!r}")


def _device_args(host_args, device, memo: dict):
    """The synthesized operands as the wrappers take them: packed words as
    int32 tensors (the same bits), floats as f32, bounds as they are. A
    `_rows` draw that `memo` holds is copied to `device` once."""
    import numpy as np
    import torch

    shared = {id(a) for a, _ in memo.get("rows", {}).values()}
    copies = memo.setdefault("device", {})

    def one(a):
        if not isinstance(a, np.ndarray):
            return a
        if (id(a), device) in copies:
            return copies[(id(a), device)]
        t = torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
        if id(a) in shared:
            copies[(id(a), device)] = t
        return t
    return tuple(one(a) for a in host_args)


def _wrapper(op: str) -> Callable:
    from repro_torch.kernels import bit_matvec, clause_match, coverage_gain
    from repro_torch.kernels import partition_gain
    return {"coverage_gain": coverage_gain.coverage_gain,
            "bit_matvec": bit_matvec.bit_matvec,
            "partition_gain": partition_gain.partition_gain,
            "clause_match": clause_match.clause_match}[op]


def _impl_call(op: str, args, params: Dict[str, Any]) -> Callable[[], Any]:
    return functools.partial(_wrapper(op), *args, **params)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _fits(op: str, dims: Tuple[int, ...], params: Dict[str, Any]) -> bool:
    """Does the candidate take every shape of the bucket? A `qpb` must fit
    shared memory at the bucket's upper Wv edge, so that a cached pick
    never raises on a call it is looked up for."""
    if op == "clause_match":
        return _qpb_fits(params["qpb"], pow2_bucket(max(1, dims[2])))
    return True


# host clock of the trials of a search whose operands lie on the CPU (a
# test's patched space); a module attribute so a test can replace it
_clock = time.perf_counter

GRAPH_MS = 2.0          # a CUDA-graph trial holds at least this much work
MAX_GRAPH_CALLS = 100   # ... in at most this many calls


def _host_trial(call: Callable[[], Any]) -> Callable[[], float]:
    """A trial timed on the host clock (CPU operands): seconds of one call."""
    def trial() -> float:
        t0 = _clock()
        call()
        return _clock() - t0
    return trial


def _graph_trial(call: Callable[[], Any], n: int) -> Callable[[], float]:
    """A trial timed on the card: `n` calls captured in one CUDA graph (the
    wrapper's host work drops out), one replay between two CUDA events,
    seconds per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                     # warm: lazy state (device bounds) first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def trial() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    trial.graph = graph            # keep the capture alive with the trial
    return trial


def _graph_calls(call: Callable[[], Any]) -> int:
    """Calls per graph: enough for GRAPH_MS of work, from one warm call's
    CUDA-event time."""
    import torch

    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    ms = max(start.elapsed_time(end), 1e-3)
    return max(1, min(MAX_GRAPH_CALLS, math.ceil(GRAPH_MS / ms)))


def _device_of(path: str):
    import torch

    if path == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "autotune.search times the CUDA kernels and needs a card; no "
                "CUDA device is visible, so nothing is tuned (the plain "
                "versions on the CPU have no blocks)")
        return torch.device("cuda")
    return torch.device(path)


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def search(
    workload: Sequence[Tuple[str, str, Tuple[int, ...]]] | None = None,
    *,
    seed: int = 0,
    reps: int = 3,
    out: str | None = None,
    verbose: bool = False,
    check: Callable[..., None] | None = None,
) -> Dict[str, Any]:
    """Measure every candidate for every workload entry and persist the picks.

    For each entry: the default call (no tile keyword) and every candidate of
    the op's space that fits the bucket are run once, and each output must
    be bit-equal to the default's, or AssertionError; `check(op, dims, args,
    params, out)`, when given, is called on every output too (params {} for
    the default). Timing is interleaved round robin (default, candidate 0,
    candidate 1, ..., then again `reps` times) with a median reduce, so
    slow drift biases all candidates equally. The pick is the fastest,
    ties to the earlier; the default call comes first, so a candidate is
    picked only where it beats the default, and otherwise the entry holds
    no tile (the default stays). The entry records the pick, its median ms
    (`_ms`), the default's median ms from the same rounds (`_default_ms`)
    and the calls per trial (`_calls`).
    """
    import torch

    workload = list(workload if workload is not None else DEFAULT_WORKLOAD)
    entries: Dict[str, Dict[str, Any]] = {}
    devices = set()
    memo: dict = {}                 # this search's shared draws
    for op, path, dims in workload:
        space = [p for p in SPACES.get((op, path), []) if _fits(op, dims, p)]
        if not space:
            continue
        device = _device_of(path)
        devices.add(_device_name(device))
        args = _device_args(_synth(op, dims, seed, memo), device, memo)
        params = [{}] + [dict(p) for p in space]
        calls = [_impl_call(op, args, p) for p in params]
        baseline = None
        for p, call in zip(params, calls):
            got = call()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if baseline is None:
                baseline = got
            elif not torch.equal(got, baseline):
                # a tile may move the time, never the result
                raise AssertionError(
                    f"autotune candidate {p} of {op}/{path} at {dims} differs "
                    f"from the default call's output")
            if check is not None:
                check(op, dims, args, p, got)
        del baseline, got
        if device.type == "cuda":
            n = _graph_calls(calls[0])
            trials = [_graph_trial(call, n) for call in calls]
        else:
            n = 1
            trials = [_host_trial(call) for call in calls]
        times: List[List[float]] = [[] for _ in calls]
        for _ in range(reps):
            for idx, trial in enumerate(trials):
                times[idx].append(trial())
        del trials, args
        med = [_median(t) for t in times]
        # the default call is the first of the round: it wins a tie, and
        # where no candidate beats it the entry keeps no tile (a lookup
        # then returns {}: the default)
        best = min(range(len(calls)), key=lambda i: (med[i], i))
        key = f"{op}|{path}|{bucket(op, *dims)}"
        entries[key] = dict(params[best])
        entries[key].update(_ms=med[best] * 1e3, _default_ms=med[0] * 1e3,
                            _calls=n)
        if verbose:
            print(f"{key}: {params[best] or 'the default'} {med[best] * 1e3:.4f} ms "
                  f"(default {med[0] * 1e3:.4f} ms, {n} calls a trial)",
                  flush=True)
    memo.clear()
    blob = {
        "version": CACHE_VERSION,
        "seed": seed,
        "device": ", ".join(sorted(devices)),
        "entries": dict(sorted(entries.items())),
    }
    dest = out if out is not None else cache_path()
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest, "w") as fh:
        json.dump(blob, fh, indent=2, sort_keys=True)
        fh.write("\n")
    invalidate()
    return blob


def ensure_cache(*, seed: int = 0) -> Tuple[str, int]:
    """Create the default-workload cache if the resolved path has none.

    Returns (path, n_entries).  No-op when tuning is disabled via the
    variable; without a card the search raises.
    """
    raw = os.environ.get(ENV_VAR)
    if raw is not None and raw.strip().lower() in _DISABLED:
        return ("<disabled>", 0)
    path = cache_path()
    entries = _load_entries(path)
    if entries:
        return (path, len(entries))
    blob = search(seed=seed, out=path)
    return (path, len(blob["entries"]))


def main(argv: Sequence[str] | None = None) -> int:
    import argparse
    import sys

    import torch

    ap = argparse.ArgumentParser(
        description="regenerate the CUDA kernels' tile cache (on a card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help=f"cache path (default {DEFAULT_CACHE})")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("autotune: no CUDA device is visible; the tuner times the CUDA "
              "kernels on a card and tunes nothing on the CPU", file=sys.stderr)
        return 1
    blob = search(seed=ns.seed, reps=ns.reps, out=ns.out, verbose=True)
    dest = ns.out if ns.out is not None else cache_path()
    print(f"wrote {len(blob['entries'])} entries -> {dest} ({blob['device']})")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
