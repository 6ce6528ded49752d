"""clause_match: eligible[b] = ∃k . clause_k ⊆ query_b — CUDA kernel wrapper.

Kernel: `csrc/clause_match.cu` (replaces the Pallas
`repro.kernels.clause_match.clause_match`), two launches on the current
stream: pass A compacts each clause row into its first `SLOTS` set-bit
positions and its count (`ref.clause_tokens`), pass B tests every query
against that table (`ref.token_match`), `plan`'s number of queries to a
block (or the caller's `qpb`, the autotuner's tile: one of `QPB`, whose
staged rows fit shared memory at the call's Wv, else ValueError); the
wrapper allocates the table.
With no query or no clause the answer is all-False and nothing is
launched. CPU tensors take the plain version (which ignores a valid
`qpb`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

SLOTS = 4               # tokens kept per clause; more marks it overflow
TABLE_BYTES = 4 * SLOTS + 4   # a clause's tokens and count
SMEM_BYTES = 232448     # H100 per-block shared memory opt-in (227 KB)
FLAG_BYTES = 16         # pass B's static shared memory, rounded up
MAX_Q = 32              # queries per block of pass B (one bit each)
QPB = (1, 2, 4, 8, 16, 32)  # the autotuner's space for pass B's queries a block
# pass B stages at least one query's words in shared memory
MAX_VOCAB_WORDS = (SMEM_BYTES - FLAG_BYTES) // 4


def smem_rows(qpb: int) -> int:
    """Vocab-word rows pass B stages: its queries, and their union when it
    has more than one."""
    return qpb + (qpb > 1)


def fits(qpb: int, wv: int) -> bool:
    """Do pass B's staged rows of `qpb` queries fit shared memory at `wv`?"""
    return smem_rows(qpb) * wv * 4 <= SMEM_BYTES - FLAG_BYTES


def check_qpb(qpb, wv: int) -> int:
    """`qpb` if it is one of `QPB` and fits at `wv`, else ValueError."""
    if isinstance(qpb, bool) or qpb not in QPB:
        raise ValueError(f"qpb must be one of {QPB}, got {qpb!r}")
    if not fits(qpb, wv):
        raise ValueError(f"qpb {qpb} stages {smem_rows(qpb) * wv * 4} bytes of "
                         f"shared memory at {wv} vocab words, more than "
                         f"{SMEM_BYTES - FLAG_BYTES}")
    return int(qpb)


def plan(b: int, k: int, wv: int, sms: int) -> int:
    """Queries per block of pass B. Each block reads the whole table (20
    bytes a clause) and stages its queries' words. Where the table is no
    larger than one query's words, one query a block (and no union);
    else as many as shared memory holds, leaving at least two blocks per SM
    in the grid; at most MAX_Q."""
    if wv > MAX_VOCAB_WORDS:
        raise ValueError(f"{wv} vocab words exceed the kernel's shared-memory "
                         f"limit of {MAX_VOCAB_WORDS}")
    if k * TABLE_BYTES <= wv * 4:
        return 1
    rows = (SMEM_BYTES - FLAG_BYTES) // (4 * max(1, wv))
    return max(1, min(MAX_Q, rows - 1, b // (2 * sms)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(clause_bits: torch.Tensor, *others: torch.Tensor):
    k, wv = clause_bits.shape
    tokens = torch.empty((k, SLOTS), dtype=torch.int32, device=clause_bits.device)
    count = torch.empty(k, dtype=torch.int32, device=clause_bits.device)
    vec = int(wv % 4 == 0 and _build.aligned16(clause_bits, *others))
    return tokens, count, vec


def clause_tokens(clause_bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass A alone: int32 clause_bits [K, Wv] -> (tokens [K, SLOTS], count
    [K]), as `ref.clause_tokens` defines them."""
    if _build.on_cpu(clause_bits):
        return ref.clause_tokens(clause_bits, SLOTS)
    _build.require(clause_bits, "clause_bits", torch.int32, 2)
    k, wv = clause_bits.shape
    tokens, count, vec = _operands(clause_bits)
    if k:
        _build.launch("clause_match", clause_bits.device, lambda lib, stream:
                      lib.clause_tokens_launch(clause_bits.data_ptr(),
                                               tokens.data_ptr(), count.data_ptr(),
                                               k, wv, vec, stream))
    return tokens, count


def clause_match(query_bits: torch.Tensor, clause_bits: torch.Tensor, *,
                 qpb: int | None = None) -> torch.Tensor:
    """int32 words query_bits [B, Wv], clause_bits [K, Wv] -> bool [B];
    `qpb` None: `plan`'s queries per block."""
    if qpb is not None:
        check_qpb(qpb, query_bits.shape[-1])
    b, k = query_bits.shape[0], clause_bits.shape[0]
    if b == 0 or k == 0:
        return torch.zeros(b, dtype=torch.bool, device=query_bits.device)
    if _build.on_cpu(query_bits, clause_bits) or _build.on_meta(query_bits, clause_bits):
        return ref.clause_match(query_bits, clause_bits)
    _build.require(query_bits, "query_bits", torch.int32, 2)
    _build.require(clause_bits, "clause_bits", torch.int32, 2, query_bits.device)
    wv = query_bits.shape[1]
    if clause_bits.shape[1] != wv:
        raise ValueError(f"clause_bits has {clause_bits.shape[1]} words, "
                         f"query_bits has {wv}")
    dev = query_bits.device
    if qpb is None:
        qpb = plan(b, k, wv, _sms(dev.index if dev.index is not None
                                  else torch.cuda.current_device()))
    tokens, count, vec = _operands(clause_bits, query_bits)
    out = torch.empty(b, dtype=torch.bool, device=dev)
    _build.launch("clause_match", dev, lambda lib, stream:
                  lib.clause_match_launch(query_bits.data_ptr(),
                                          clause_bits.data_ptr(),
                                          tokens.data_ptr(), count.data_ptr(),
                                          out.data_ptr(), b, k, wv, qpb, vec,
                                          stream))
    return out
