"""coverage_gain: gains[c] = popcount(A[c] & ~mask) — CUDA kernel wrapper.

Kernel: `csrc/coverage_gain.cu` (replaces the Pallas
`repro.kernels.coverage_gain.coverage_gain`). CPU tensors take the plain
version `ref.coverage_gain`; CUDA tensors launch the kernel or raise.
`warps` is the kernel's rows per block (`tiles.WARPS`; the autotuner's
tile); the plain version ignores it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import DEFAULT_WARPS, check_warps


def coverage_gain(a_bits: torch.Tensor, mask: torch.Tensor, *,
                  warps: int = DEFAULT_WARPS) -> torch.Tensor:
    """int32 words a_bits [C, W], mask [W] -> int32 [C]."""
    check_warps(warps)
    if _build.on_cpu(a_bits, mask):
        return ref.coverage_gain(a_bits, mask)
    _build.require(a_bits, "a_bits", torch.int32, 2)
    _build.require(mask, "mask", torch.int32, 1, a_bits.device)
    c, w = a_bits.shape
    if mask.shape[0] != w:
        raise ValueError(f"mask has {mask.shape[0]} words, a_bits has {w}")
    out = torch.empty(c, dtype=torch.int32, device=a_bits.device)
    if c == 0:
        return out
    vec = int(w % 4 == 0 and _build.aligned16(a_bits, mask))
    _build.launch("coverage_gain", a_bits.device, lambda lib, stream:
                  lib.coverage_gain_launch(a_bits.data_ptr(), mask.data_ptr(),
                                           out.data_ptr(), c, w, vec, warps,
                                           stream))
    return out
