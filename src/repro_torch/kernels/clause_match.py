"""clause_match: eligible[b] = ∃k . clause_k ⊆ query_b — CUDA kernel wrapper.

Kernel: `csrc/clause_match.cu` (replaces the Pallas
`repro.kernels.clause_match.clause_match`). With no query or no clause the
answer is all-False and nothing is launched. CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# the kernel stages at least one query's words in shared memory (227 KiB)
MAX_VOCAB_WORDS = 232448 // 4


def clause_match(query_bits: torch.Tensor,
                 clause_bits: torch.Tensor) -> torch.Tensor:
    """int32 words query_bits [B, Wv], clause_bits [K, Wv] -> bool [B]."""
    b, k = query_bits.shape[0], clause_bits.shape[0]
    if b == 0 or k == 0:
        return torch.zeros(b, dtype=torch.bool, device=query_bits.device)
    if _build.on_cpu(query_bits, clause_bits):
        return ref.clause_match(query_bits, clause_bits)
    _build.require(query_bits, "query_bits", torch.int32, 2)
    _build.require(clause_bits, "clause_bits", torch.int32, 2, query_bits.device)
    wv = query_bits.shape[1]
    if clause_bits.shape[1] != wv:
        raise ValueError(f"clause_bits has {clause_bits.shape[1]} words, "
                         f"query_bits has {wv}")
    if wv > MAX_VOCAB_WORDS:
        raise ValueError(f"{wv} vocab words exceed the kernel's shared-memory "
                         f"limit of {MAX_VOCAB_WORDS}")
    out = torch.empty(b, dtype=torch.bool, device=query_bits.device)
    _build.launch("clause_match", query_bits.device, lambda lib, stream:
                  lib.clause_match_launch(query_bits.data_ptr(),
                                          clause_bits.data_ptr(),
                                          out.data_ptr(), b, k, wv, stream))
    return out
