"""sparse_gain: gains[c] = #{m : ids[c, m] >= 0 and bit(mask, ids[c, m]) = 0}
— CUDA kernel wrapper.

Kernel: `csrc/sparse_gain.cu` (replaces the Pallas
`repro.kernels.sparse_gain.sparse_gain`). CPU tensors take the plain
version `ref.sparse_gain`; CUDA tensors launch the kernel or raise. Every
id must lie below 32 * W (a -1 anywhere is padding).

The kernel stages the covered bitset in shared memory when its W * 4 bytes
fit the per-block opt-in limit, and gathers it through L2 otherwise; the
route follows from W alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

SMEM_BYTES = 232448     # H100 per-block shared memory opt-in (227 KB)


def smem_route(w: int) -> bool:
    """True when a W-word mask is staged in shared memory."""
    return w * 4 <= SMEM_BYTES


def sparse_gain(doc_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 doc_ids [C, M] (-1 padded), int32 words mask [W] -> int32 [C]."""
    if _build.on_cpu(doc_ids, mask) or _build.on_meta(doc_ids, mask):
        return ref.sparse_gain(doc_ids, mask)
    _build.require(doc_ids, "doc_ids", torch.int32, 2)
    _build.require(mask, "mask", torch.int32, 1, doc_ids.device)
    c, m = doc_ids.shape
    w = mask.shape[0]
    out = torch.empty(c, dtype=torch.int32, device=doc_ids.device)
    if c == 0:
        return out
    vec = int(m % 4 == 0 and _build.aligned16(doc_ids))
    _build.launch("sparse_gain", doc_ids.device, lambda lib, stream:
                  lib.sparse_gain_launch(
                      doc_ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
                      c, m, w, vec, int(smem_route(w)), stream))
    return out
