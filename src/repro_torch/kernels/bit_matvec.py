"""bit_matvec: out [C, R] = unpack(A [C, W]) @ x [W*32, R] — CUDA kernel wrapper.

Kernel: `csrc/bit_matvec.cu` (replaces the Pallas
`repro.kernels.bit_matvec.bit_matvec`). Both the kernel and the plain
version `ref.bit_matvec` sum in FP64 and round once to FP32, so they agree
whatever their summation orders (allclose is what is checked; equal is what
the solvers' orders rely on). CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. `warps` is the kernel's tasks per block
(`tiles.WARPS`; the autotuner's tile); each task's sum does not depend on
it, and the plain version ignores it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import DEFAULT_WARPS, WORD, check_warps


def bit_matvec(a_bits: torch.Tensor, x: torch.Tensor, *,
               warps: int = DEFAULT_WARPS) -> torch.Tensor:
    """int32 words a_bits [C, W], f32 x [W*32, R] -> f32 [C, R]."""
    check_warps(warps)
    if _build.on_cpu(a_bits, x) or _build.on_meta(a_bits, x):
        return ref.bit_matvec(a_bits, x)
    _build.require(a_bits, "a_bits", torch.int32, 2)
    _build.require(x, "x", torch.float32, 2, a_bits.device)
    c, w = a_bits.shape
    r = x.shape[1]
    if x.shape[0] != w * WORD:
        raise ValueError(f"x has {x.shape[0]} rows, need {w * WORD} for {w} words")
    out = torch.empty((c, r), dtype=torch.float32, device=a_bits.device)
    if c * r == 0:
        return out
    vec = int(w % 4 == 0 and _build.aligned16(a_bits))
    _build.launch("bit_matvec", a_bits.device, lambda lib, stream:
                  lib.bit_matvec_launch(a_bits.data_ptr(), x.data_ptr(),
                                        out.data_ptr(), c, w, r, vec, warps,
                                        stream))
    return out
