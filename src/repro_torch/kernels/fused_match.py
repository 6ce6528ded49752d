"""Tier-selected AND-match (CUDA kernel wrapper) and the fused serve step.

Kernel: `csrc/tier_match.cu` (replaces the Pallas
`repro.kernels.fused_match._tier_match` and serves the reference engine's
XLA `repro.serve.matching.match_batch`). The two tiers come in as two
tensors; no [2V, W] stack is built.

`fused_match` is ψ classify then the tier-selected match: two launches on
one stream with no host sync between them, as the reference's jitted
wrapper is one dispatch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.clause_match import clause_match

MAX_WORD_BLOCKS = 65535          # gridDim.y limit
THREADS = 256                    # kMatchThreads in csrc/tier_match.cu


def tier_match(t1: torch.Tensor, t2: torch.Tensor, sel: torch.Tensor | None,
               tokens: torch.Tensor) -> torch.Tensor:
    """Per query b, AND of the postings rows of tokens[b] (-1 skipped), taken
    from `t1` where sel[b] and from `t2` otherwise (sel None: all `t2`).

    t1, t2: int32 words [V, W]; sel: bool [B] or None; tokens: int32 [B, L]
    with ids in [-1, V). Returns int32 words [B, W]; all-ones for a query
    with no valid token.
    """
    if _build.on_cpu(t1, t2, sel, tokens) or _build.on_meta(t1, t2, sel, tokens):
        return ref.tier_match(t1, t2, sel, tokens)
    _build.require(t2, "t2", torch.int32, 2)
    dev = t2.device
    _build.require(t1, "t1", torch.int32, 2, dev)
    _build.require(tokens, "tokens", torch.int32, 2, dev)
    if sel is not None:
        _build.require(sel, "sel", torch.bool, 1, dev)
    v, w = t2.shape
    b, ell = tokens.shape
    if t1.shape != t2.shape:
        raise ValueError(f"tiers differ in shape: {tuple(t1.shape)} vs {tuple(t2.shape)}")
    if sel is not None and sel.shape[0] != b:
        raise ValueError(f"sel has {sel.shape[0]} entries for {b} queries")
    out = torch.empty((b, w), dtype=torch.int32, device=dev)
    if b == 0 or w == 0:
        return out
    vec = int(w % 4 == 0 and _build.aligned16(t1, t2, out))
    if -(-(w // 4 if vec else w) // THREADS) > MAX_WORD_BLOCKS:
        raise ValueError(f"{w} postings words exceed the kernel's grid")
    sel_ptr = None if sel is None else sel.data_ptr()
    _build.launch("tier_match", dev, lambda lib, stream:
                  lib.tier_match_launch(t1.data_ptr(), t2.data_ptr(), sel_ptr,
                                        tokens.data_ptr(), out.data_ptr(),
                                        b, ell, w, v, vec, stream))
    return out


def fused_match(query_bits: torch.Tensor, clause_bits: torch.Tensor,
                tokens: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor):
    """ψ classify + tier-selected AND-match. Returns ``(match [B, W] int32
    words, eligible [B] bool)``; an empty clause set routes every query to
    Tier-2."""
    elig = clause_match(query_bits, clause_bits)
    return tier_match(t1, t2, elig, tokens), elig
