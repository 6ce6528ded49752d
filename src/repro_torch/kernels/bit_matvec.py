"""bit_matvec: out [C, R] = unpack(A [C, W]) @ x [W*32, R] — CUDA kernel wrapper.

Kernel: `csrc/bit_matvec.cu` (replaces the Pallas
`repro.kernels.bit_matvec.bit_matvec`). Both the kernel and the plain
version `ref.bit_matvec` sum in FP64 and round once to FP32, so they agree
whatever their summation orders (allclose is what is checked; equal is what
the solvers' orders rely on). CPU tensors take the plain version; CUDA
tensors launch the kernel or raise. Two routes (`tiles.gain_route`, by
shape): "warp", a warp a (row, column) task, and "split", a task to a
thread-block cluster, for calls of at most 1024 tasks over rows of at
least 2048 words (`tiles.SPLIT_MAX_TASKS`, `SPLIT_MIN_WORDS`: lazy's exact
evaluations and ingest's offers at production widths); `route=` forces
one. `warps`
is the warps a block (`tiles.WARPS`; the autotuner's tile): tasks a block
on the warp route, warps a CTA on the split route; the plain version
ignores both.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import (DEFAULT_WARPS, WORD, check_route, check_warps,
                                       gain_route, split_ctas)


def bit_matvec(a_bits: torch.Tensor, x: torch.Tensor, *,
               warps: int = DEFAULT_WARPS, route: str | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 words a_bits [C, W], f32 x [W*32, R] -> f32 [C, R] (into
    `out`, an f32 [C, R] tensor beside the operands, when given)."""
    check_warps(warps)
    check_route(route)
    if _build.on_cpu(a_bits, x) or _build.on_meta(a_bits, x):
        got = ref.bit_matvec(a_bits, x)
        return got if out is None else out.copy_(got)
    _build.require(a_bits, "a_bits", torch.int32, 2)
    _build.require(x, "x", torch.float32, 2, a_bits.device)
    c, w = a_bits.shape
    r = x.shape[1]
    if x.shape[0] != w * WORD:
        raise ValueError(f"x has {x.shape[0]} rows, need {w * WORD} for {w} words")
    out = _build.output(out, (c, r), torch.float32, a_bits.device)
    if c * r == 0:
        return out
    if (route or gain_route("bit_matvec", c * r, w)) == "split":
        ctas = split_ctas(w)
        _build.launch("bit_matvec_split", a_bits.device, lambda lib, stream:
                      lib.bit_matvec_split_launch(
                          a_bits.data_ptr(), x.data_ptr(), out.data_ptr(), c, w, r,
                          ctas, warps, stream))
        return out
    vec = int(w % 4 == 0 and _build.aligned16(a_bits))
    _build.launch("bit_matvec", a_bits.device, lambda lib, stream:
                  lib.bit_matvec_launch(a_bits.data_ptr(), x.data_ptr(),
                                        out.data_ptr(), c, w, r, vec, warps,
                                        stream))
    return out
