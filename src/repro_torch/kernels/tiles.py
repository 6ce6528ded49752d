"""Tiling arithmetic shared by the kernel wrappers (a copy of
`repro.kernels.tiles`)."""
from __future__ import annotations

WORD = 32


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
    b = 1
    while b < n:
        b *= 2
    return b
