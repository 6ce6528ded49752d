"""Public kernel ops of the port.

Placement follows the operands' device: CPU tensors take the plain PyTorch
version (`kernels.ref`), CUDA tensors launch the hand-written kernel or
raise. There is no other switch.

Dispatch cost accounting (`repro_torch.obs.profile`): each op the
reference accounts (`bit_matvec`, `coverage_gain`, `clause_match`,
`partition_gain`, `sparse_gain`, `fused_match`) reports the reference's
shape-derived word and byte models to the process profiler on every call
while the telemetry plane is on, labelled `(op, path)` with path "cuda" or
"cpu" (where the operands lie). With the plane off the only cost is one
`_state.on` check, and results are bit-identical either way. `tier_match`
and `match_batch` are not accounted, as the reference's `match_batch` is
not.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import bit_matvec as _bm
from repro_torch.kernels import clause_match as _cm
from repro_torch.kernels import coverage_gain as _cg
from repro_torch.kernels import fused_match as _fm
from repro_torch.kernels import partition_gain as _pg
from repro_torch.kernels import sparse_gain as _sg
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_match import tier_match  # noqa: F401
from repro_torch.kernels.tiles import block_dim  # noqa: F401  (public re-export)
from repro_torch.obs import _state as _obs_state

WORD = 32


# -- dispatch cost accounting (repro_torch.obs.profile) ------------------------
# The reference's models: uint32 postings words read per call, plus modelled
# HBM bytes (uint32/f32 operands + result).

def _cost_bit_matvec(a_bits, x):
    c, w = a_bits.shape
    r = int(x.shape[-1])
    return c * w, 4 * (c * w + w * WORD * r + c * r)


def _cost_coverage_gain(a_bits, mask):
    c, w = a_bits.shape
    return c * w, 4 * (c * w + w + c)


def _cost_clause_match(query_bits, clause_bits):
    b, wv = query_bits.shape
    k = clause_bits.shape[0]
    return (b + k) * wv, 4 * (b + k) * wv + b


def _cost_partition_gain(a_bits, mask, bounds):
    c, w = a_bits.shape
    p = len(bounds) - 1
    return c * w + w, 4 * (c * w + w + c * p)


def _cost_sparse_gain(doc_ids, mask):
    c, m = doc_ids.shape
    return c * m, 4 * (2 * c * m + c)


def _cost_fused_match(query_bits, clause_bits, tokens, t1, t2):
    b, wv = query_bits.shape
    k = clause_bits.shape[0]
    ell = tokens.shape[1]
    w = t1.shape[-1]
    words = (b + k) * wv + b * ell * w          # classify reads + row gathers
    return words, 4 * words + 4 * b * w + b


_PROF = None


def _profiler():
    global _PROF
    if _PROF is None:                # bind late: repro_torch.obs owns the singleton
        from repro_torch import obs
        _PROF = obs.PROFILER
    return _PROF


def path_of(t: torch.Tensor) -> str:
    """The `path` label of a call: where its operands lie."""
    return "cuda" if t.is_cuda else "cpu"


def _run(op: str, fn, cost, *args):
    """`fn(*args)`, with cost accounting while the plane is on."""
    if not _obs_state.on:
        return fn(*args)
    prof = _profiler()
    words, nbytes = cost(*args)
    t0 = time.perf_counter() if prof.active else 0.0
    out = fn(*args)
    prof.record(op, path_of(args[0]), words, nbytes,
                out=out if prof.active else None, t0=t0)
    return out


# -- public ops ----------------------------------------------------------------

def bit_matvec(a_bits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """gains [C, R] = unpack(a_bits [C, W]) @ x [W*32, R]."""
    return _run("bit_matvec", _bm.bit_matvec, _cost_bit_matvec, a_bits, x)


def coverage_gain(a_bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """gains [C] = popcount(a_bits & ~mask)."""
    return _run("coverage_gain", _cg.coverage_gain, _cost_coverage_gain,
                a_bits, mask)


def clause_match(query_bits: torch.Tensor,
                 clause_bits: torch.Tensor) -> torch.Tensor:
    """eligible [B] bool = any clause row is a bitwise subset of the query
    (ψ^clause, paper eq. 8). Empty operands launch nothing and are not
    accounted."""
    if clause_bits.shape[0] == 0 or query_bits.shape[0] == 0:
        return _cm.clause_match(query_bits, clause_bits)
    return _run("clause_match", _cm.clause_match, _cost_clause_match,
                query_bits, clause_bits)


def fused_match(query_bits: torch.Tensor, clause_bits: torch.Tensor,
                tokens: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor):
    """ψ classify + tier-selected AND-match: ``(match [B, W] int32 words,
    eligible [B] bool)``, two launches with no host sync between them."""
    return _run("fused_match", _fm.fused_match, _cost_fused_match,
                query_bits, clause_bits, tokens, t1, t2)


def partition_gain(a_bits: torch.Tensor, mask: torch.Tensor,
                   bounds) -> torch.Tensor:
    """gains [C, P]: per-partition popcount(a & ~mask) over the word ranges
    of `bounds` (P+1 word offsets)."""
    bounds = tuple(int(b) for b in bounds)

    def cost(a, m):
        return _cost_partition_gain(a, m, bounds)

    def fn(a, m):
        return _pg.partition_gain(a, m, bounds)

    return _run("partition_gain", fn, cost, a_bits, mask)


def sparse_gain(doc_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """gains [C] over -1-padded doc-id lists."""
    return _run("sparse_gain", _sg.sparse_gain, _cost_sparse_gain,
                doc_ids, mask)


def match_batch(postings: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """AND of postings rows per query over one tier (-1 tokens skipped)."""
    return tier_match(postings, postings, None, tokens)
