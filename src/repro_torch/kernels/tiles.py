"""Tiling arithmetic shared by the kernel wrappers (a copy of
`repro.kernels.tiles`), and the block sizes the warp-per-row kernels take."""
from __future__ import annotations

WORD = 32
# warps per block of coverage_gain, bit_matvec and partition_gain (one row,
# or one (row, column) task, per warp): the autotuner's space for them
WARPS = (1, 2, 4, 8, 16, 32)
DEFAULT_WARPS = 8


def check_warps(warps) -> int:
    """`warps` if it is one of `WARPS`, else ValueError (before any launch)."""
    if isinstance(warps, bool) or warps not in WARPS:
        raise ValueError(f"warps must be one of {WARPS}, got {warps!r}")
    return int(warps)


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
