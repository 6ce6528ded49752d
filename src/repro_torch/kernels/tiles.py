"""Tiling arithmetic shared by the kernel wrappers (a copy of
`repro.kernels.tiles`), the block sizes the warp-per-row kernels take, and
the route of `coverage_gain`, `bit_matvec` and `partition_gain` calls."""
from __future__ import annotations

WORD = 32
# warps per block of coverage_gain, bit_matvec and partition_gain (on the warp
# route one row, or one (row, column) task, per warp; on the split route, the
# warps of each CTA of a row's cluster): the autotuner's space for them
WARPS = (1, 2, 4, 8, 16, 32)
DEFAULT_WARPS = 8


def check_warps(warps) -> int:
    """`warps` if it is one of `WARPS`, else ValueError (before any launch)."""
    if isinstance(warps, bool) or warps not in WARPS:
        raise ValueError(f"warps must be one of {WARPS}, got {warps!r}")
    return int(warps)


# routes of coverage_gain, bit_matvec and partition_gain (csrc/coverage_gain.cu,
# csrc/bit_matvec.cu, csrc/partition_gain.cu): "warp", a warp a task (a row,
# or a (row, column) of bit_matvec), for calls of many tasks; "split", a task
# to a thread-block cluster of CTAs that each take a slice of the row's
# words, for calls whose tasks cannot fill the card (lazy greedy's exact
# evaluations and ingest's offers: one row). The shape picks the route
# (`gain_route`); a wrapper's `route=` keyword forces one (tests and
# `chip_smoke.py` only). The limits are where the split route stopped
# winning in a sweep of both routes' device time on the production rows,
# the densest and random ones (`chip_smoke.py` phase 1b/2b/5b,
# `tools/one_row_probe.py`; PERF.md): `coverage_gain` streams its words, so
# one warp a row is as fast below 8192 words a row, and a full card of warps
# above 128 rows; `bit_matvec`'s warp walks its row's set bits in turn, so
# spreading a row wins up to 1024 tasks from 2048 words a row (below that,
# 16-byte loads of a short aligned row let one warp win at few rows);
# `partition_gain`'s warp walks each partition in turn, with a scalar head
# and tail each, so its split route wins up to 128 rows from 8192 words a
# row. Its split route keeps a count a partition for each warp in shared
# memory, so it takes at most SPLIT_MAX_PARTS partitions; a call of more
# takes the warp route.
ROUTES = ("warp", "split")
SPLIT_MAX_TASKS = {"coverage_gain": 128, "bit_matvec": 1024, "partition_gain": 128}
SPLIT_MIN_WORDS = {"coverage_gain": 8192, "bit_matvec": 2048, "partition_gain": 8192}
SPLIT_MAX_PARTS = 1024   # partition_gain's split route (csrc/partition_gain.cu kSplitMaxParts)
SPLIT_WORDS = 4096       # words a split-route CTA takes, as far as MAX_SPLIT_CTAS allow
MAX_SPLIT_CTAS = 8       # CTAs a cluster (portable size)


def gain_route(kernel: str, tasks: int, w: int, parts: int = 1) -> str:
    """The route a call of `kernel` ("coverage_gain", "bit_matvec" or
    "partition_gain") with `tasks` tasks (rows; (row, column) pairs of
    bit_matvec) over rows of `w` words, in `parts` partitions
    (partition_gain), takes."""
    split = (tasks <= SPLIT_MAX_TASKS[kernel] and w >= SPLIT_MIN_WORDS[kernel]
             and parts <= SPLIT_MAX_PARTS)
    return "split" if split else "warp"


def split_ctas(w: int) -> int:
    """CTAs in a split-route cluster for rows of `w` words."""
    return max(1, min(MAX_SPLIT_CTAS, -(-int(w) // SPLIT_WORDS)))


def check_route(route):
    """`route` if it is None (the shape decides) or one of `ROUTES`, else
    ValueError (before any launch)."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    return route


def block_dim(n: int, block: int) -> tuple[int, int, int]:
    """Shared pad-to-block/grid setup.

    Clamps the requested block size to the actual extent and returns
    ``(block, pad, n_blocks)`` so callers pad `n` up to ``n + pad`` (a
    multiple of ``block``) and launch ``n_blocks`` grid steps along the axis.
    """
    b = max(1, min(block, n))
    pad = -n % b
    return b, pad, (n + pad) // b


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()
