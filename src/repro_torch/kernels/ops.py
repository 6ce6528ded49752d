"""Public kernel ops of the port.

Placement follows the operands' device: CPU tensors take the plain PyTorch
version (`kernels.ref`), CUDA tensors launch the hand-written kernel or
raise. There is no other switch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bit_matvec import bit_matvec  # noqa: F401
from repro_torch.kernels.clause_match import clause_match  # noqa: F401
from repro_torch.kernels.coverage_gain import coverage_gain  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_match import fused_match, tier_match  # noqa: F401
from repro_torch.kernels.partition_gain import partition_gain  # noqa: F401
from repro_torch.kernels.sparse_gain import sparse_gain  # noqa: F401
from repro_torch.kernels.tiles import block_dim  # noqa: F401  (public re-export)


def match_batch(postings: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """AND of postings rows per query over one tier (-1 tokens skipped)."""
    return tier_match(postings, postings, None, tokens)
