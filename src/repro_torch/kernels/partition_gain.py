"""partition_gain: gains[c, k] = popcount(A[c, lo_k:hi_k] & ~mask[lo_k:hi_k])
— CUDA kernel wrapper.

Kernel: `csrc/partition_gain.cu` (replaces the Pallas
`repro.kernels.partition_gain.partition_gain`). CPU tensors take the plain
version `ref.partition_gain`; CUDA tensors launch the kernel or raise. Two
routes (`tiles.gain_route`, by shape): "warp", a warp a row, and "split", a
row to a thread-block cluster, for calls of at most
`tiles.SPLIT_MAX_TASKS["partition_gain"]` rows of at least
`tiles.SPLIT_MIN_WORDS["partition_gain"]` words in at most
`tiles.SPLIT_MAX_PARTS` partitions (lazy's exact evaluations under per-shard
caps and ingest's offers on a per-shard constraint at production widths);
`route=` forces one, and a forced split route over more partitions raises
before any launch. `warps` is the warps a block (`tiles.WARPS`; the
autotuner's tile): rows a block on the warp route, warps a CTA on the split
route. Neither moves a result; the plain version ignores both. `out=`, an
int32 [C, P] tensor beside the operands, receives the counts in place of a
new tensor.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tiles import (DEFAULT_WARPS, SPLIT_MAX_PARTS, check_route,
                                       check_warps, gain_route, split_ctas)


def check_bounds(bounds, w: int) -> tuple[int, ...]:
    """`bounds` as a tuple of P+1 ascending word offsets from 0 to `w`."""
    b = tuple(int(x) for x in bounds)
    if len(b) < 2 or b[0] != 0 or b[-1] != w or \
            any(lo >= hi for lo, hi in zip(b, b[1:])):
        raise ValueError(f"bounds must ascend from 0 to {w} words, got {b}")
    return b


@functools.lru_cache(maxsize=64)
def _device_bounds(bounds: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The offsets as an int64 tensor on `device`, copied there once per
    split (a fresh copy per launch would be a host round trip per step)."""
    return torch.tensor(bounds, dtype=torch.int64, device=device)


def partition_gain(a_bits: torch.Tensor, mask: torch.Tensor, bounds, *,
                   warps: int = DEFAULT_WARPS, route: str | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """int32 words a_bits [C, W], mask [W], P+1 word offsets -> int32 [C, P]."""
    check_warps(warps)
    check_route(route)
    c, w = a_bits.shape
    bounds = check_bounds(bounds, w)
    p = len(bounds) - 1
    if _build.on_cpu(a_bits, mask) or _build.on_meta(a_bits, mask):
        got = ref.partition_gain(a_bits, mask, bounds)
        return got if out is None else out.copy_(got)
    _build.require(a_bits, "a_bits", torch.int32, 2)
    _build.require(mask, "mask", torch.int32, 1, a_bits.device)
    if mask.shape[0] != w:
        raise ValueError(f"mask has {mask.shape[0]} words, a_bits has {w}")
    out = _build.output(out, (c, p), torch.int32, a_bits.device)
    if c == 0:
        return out
    split = (route or gain_route("partition_gain", c, w, p)) == "split"
    if split and p > SPLIT_MAX_PARTS:
        raise ValueError(f"the split route takes at most {SPLIT_MAX_PARTS} partitions, "
                         f"got {p}")
    dev_bounds = _device_bounds(bounds, a_bits.device)
    if split:
        ctas = split_ctas(w)
        _build.launch("partition_gain_split", a_bits.device, lambda lib, stream:
                      lib.partition_gain_split_launch(
                          a_bits.data_ptr(), mask.data_ptr(), dev_bounds.data_ptr(),
                          out.data_ptr(), c, w, p, ctas, warps, stream))
        return out
    vec = int(w % 4 == 0 and _build.aligned16(a_bits, mask))
    _build.launch("partition_gain", a_bits.device, lambda lib, stream:
                  lib.partition_gain_launch(
                      a_bits.data_ptr(), mask.data_ptr(), dev_bounds.data_ptr(),
                      out.data_ptr(), c, w, p, vec, warps, stream))
    return out
