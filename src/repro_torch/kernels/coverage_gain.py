"""coverage_gain: gains[c] = popcount(A[c] & ~mask) — CUDA kernel wrapper.

Kernel: `csrc/coverage_gain.cu` (replaces the Pallas
`repro.kernels.coverage_gain.coverage_gain`). CPU tensors take the plain
version `ref.coverage_gain`; CUDA tensors launch the kernel or raise. Two
routes (`tiles.gain_route`, by shape): "warp", a warp a row, and "split", a
row to a thread-block cluster, for calls of at most 128 rows of at least
8192 words (`tiles.SPLIT_MAX_TASKS`, `SPLIT_MIN_WORDS`: lazy's exact
evaluations and ingest's offers at production widths); `route=` forces one.
`warps` is the warps a block (`tiles.WARPS`; the autotuner's tile): rows a
block on the warp route, warps a CTA on the split route. Neither moves a
result; the plain version ignores both.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import (DEFAULT_WARPS, check_route, check_warps,
                                       gain_route, split_ctas)


def coverage_gain(a_bits: torch.Tensor, mask: torch.Tensor, *,
                  warps: int = DEFAULT_WARPS, route: str | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 words a_bits [C, W], mask [W] -> int32 [C] (into `out`, an
    int32 [C] tensor beside the operands, when given)."""
    check_warps(warps)
    check_route(route)
    if _build.on_cpu(a_bits, mask) or _build.on_meta(a_bits, mask):
        got = ref.coverage_gain(a_bits, mask)
        return got if out is None else out.copy_(got)
    _build.require(a_bits, "a_bits", torch.int32, 2)
    _build.require(mask, "mask", torch.int32, 1, a_bits.device)
    c, w = a_bits.shape
    if mask.shape[0] != w:
        raise ValueError(f"mask has {mask.shape[0]} words, a_bits has {w}")
    out = _build.output(out, (c,), torch.int32, a_bits.device)
    if c == 0:
        return out
    if (route or gain_route("coverage_gain", c, w)) == "split":
        ctas = split_ctas(w)
        _build.launch("coverage_gain_split", a_bits.device, lambda lib, stream:
                      lib.coverage_gain_split_launch(
                          a_bits.data_ptr(), mask.data_ptr(), out.data_ptr(), c, w,
                          ctas, warps, stream))
        return out
    vec = int(w % 4 == 0 and _build.aligned16(a_bits, mask))
    _build.launch("coverage_gain", a_bits.device, lambda lib, stream:
                  lib.coverage_gain_launch(a_bits.data_ptr(), mask.data_ptr(),
                                           out.data_ptr(), c, w, vec, warps,
                                           stream))
    return out
