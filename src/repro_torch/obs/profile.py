"""Per-dispatch kernel cost accountant: words, bytes, device-sync wall.

The port's counterpart of `repro.obs.profile`. Every public tiering op in
`repro_torch.kernels.ops` reports a shape-derived cost model (uint32
postings words read, modelled HBM bytes for operands + result) to the
process profiler on each dispatch, labelled `(op, path)` where path is
where the operands lie: "cuda" (the hand-written kernel) or "cpu" (its
plain PyTorch version), or "mesh" for the owner-local fusion over a shard
mesh (`ops.partition_gain` under `distributed.use_mesh`). The word and byte models are the reference's.
Two tiers of accounting:

  * always (while the plane is on): two counter incs —
    `kernel_words_scanned_total{op,path}` and
    `kernel_bytes_moved_total{op,path}` — cheap enough for production
    dispatch, and what the CI telemetry smoke asserts on.
  * measuring (explicit `with PROFILER.measuring():`): additionally waits
    for each result's CUDA device (`spans.block_until_ready`) and accrues
    the wall-clock from just before the launch per (op, path), so
    `summary()` can derive per-kernel achieved bandwidth and the
    achieved-vs-roofline fraction. Waiting defeats asynchronous launches,
    so this tier is opt-in — benchmarks only.

Under `REPRO_OBS=0` the ops never call in here at all (they gate on the
same `_state.on` switch), so profiling is a complete no-op and serve
results stay bit-identical.

The peak numbers are the NVIDIA H100 SXM5 80GB data sheet's (the card
`chip_smoke.py` runs on, `NVIDIA H100 80GB HBM3`): 989 TFLOP/s bf16 dense
on the tensor cores, 3.35 TB/s HBM3, and 450 GB/s per direction of NVLink 4
(900 GB/s bidirectional) in the role the reference's ICI link plays.
"""
from __future__ import annotations

import contextlib
import time

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.spans import block_until_ready

# NVIDIA H100 SXM5 80GB (NVIDIA H100 80GB HBM3), data sheet, dense rates
PEAK_FLOPS = 989e12    # bf16 tensor cores
HBM_BW = 3.35e12       # HBM3 bytes/s
ICI_BW = 450e9         # NVLink 4, bytes/s per direction (the ICI link's role)


class KernelProfiler:
    """Aggregates per-(op, path) dispatch costs; see the module docstring."""

    def __init__(self, registry: MetricsRegistry):
        self._words = registry.counter(
            "kernel_words_scanned_total",
            "uint32 postings words read per kernel dispatch",
            labels=("op", "path"))
        self._bytes = registry.counter(
            "kernel_bytes_moved_total",
            "modelled HBM bytes (operands + result) per kernel dispatch",
            labels=("op", "path"))
        self.active = False
        self._agg: dict[tuple[str, str], dict] = {}

    def record(self, op: str, path: str, words: int, nbytes: int,
               out=None, t0: float = 0.0) -> None:
        """One dispatch. With `out` (measuring mode) also waits for it and
        accrues wall-clock from `t0` (taken just before the dispatch)."""
        self._words.inc(words, op=op, path=path)
        self._bytes.inc(nbytes, op=op, path=path)
        if not (self.active and out is not None):
            return
        block_until_ready(out)
        dt = time.perf_counter() - t0
        a = self._agg.setdefault((op, path), {"calls": 0, "words": 0,
                                              "bytes": 0, "sync_s": 0.0})
        a["calls"] += 1
        a["words"] += int(words)
        a["bytes"] += int(nbytes)
        a["sync_s"] += dt

    @contextlib.contextmanager
    def measuring(self):
        """Scope where dispatches are synchronously timed (benchmarks)."""
        prev, self.active = self.active, True
        try:
            yield self
        finally:
            self.active = prev

    @contextlib.contextmanager
    def scoped(self):
        """Isolated measured-aggregation scope: enters empty, and whatever
        was accrued before the scope is restored on exit. Benchmark
        subsections wrap themselves in this so `profile` / `profile_mesh`
        rows can never mix counters accumulated by an earlier subsection
        (or by warmup dispatches) in the same process."""
        saved, self._agg = self._agg, {}
        try:
            yield self
        finally:
            self._agg = saved

    def summary(self) -> list[dict]:
        """Measured aggregation as JSON-ready rows, one per (op, path):
        totals plus achieved GB/s and the fraction of the HBM roofline."""
        rows = []
        for (op, path), a in sorted(self._agg.items()):
            sync = max(a["sync_s"], 1e-12)
            gbps = a["bytes"] / sync / 1e9
            rows.append({
                "op": op, "path": path, "calls": a["calls"],
                "words_scanned": int(a["words"]),
                "bytes_moved": int(a["bytes"]),
                "sync_s": round(a["sync_s"], 6),
                "us_per_call": round(1e6 * a["sync_s"] / max(a["calls"], 1),
                                     3),
                "achieved_gbps": round(gbps, 3),
                "roofline_frac": round(gbps / (HBM_BW / 1e9), 6),
            })
        return rows

    def reset(self) -> None:
        """Drop the measured aggregation (the registry counters are owned
        by the registry and reset with it)."""
        self._agg.clear()
