"""Public kernel ops of the port.

Placement follows the operands' device: CPU tensors take the plain PyTorch
version (`kernels.ref`), CUDA tensors launch the hand-written kernel or
raise. There is no other switch.

Dispatch cost accounting (`repro_torch.obs.profile`): each op the
reference accounts (`bit_matvec`, `coverage_gain`, `clause_match`,
`partition_gain`, `sparse_gain`, `fused_match`) reports the reference's
shape-derived word and byte models to the process profiler on every call
while the telemetry plane is on, labelled `(op, path)` with path "cuda" or
"cpu" (where the operands lie), or "mesh" for `partition_gain`'s
owner-local path over a shard mesh. With the plane off the only cost is one
`_state.on` check, and results are bit-identical either way. `tier_match`
and `match_batch` are not accounted, as the reference's `match_batch` is
not.

Tiles: `bit_matvec`, `coverage_gain`, `clause_match` and the direct
`partition_gain` look their shape bucket up through
`ExecutionPlan.tile_params` (`kernels.autotune`'s cache; a memoised probe)
and pass a hit to the wrapper as a keyword, as the reference's dispatch
does. A miss, or the cache turned off, keeps the wrapper's defaults. The
mesh path of `partition_gain` is not tuned, as the reference's fused path
is not.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch import distributed as _dist
from repro_torch.kernels import autotune as _autotune
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


def _run(op: str, fn, cost, *args, path: str | None = None):
    """`fn(*args)` with the autotuned tiles of `op`'s shape bucket, and cost
    accounting while the plane is on, labelled `path` (default: where the
    operands lie)."""
    shape_bucket = _autotune.bucket_from_args(op, args)
    if shape_bucket is not None:
        tiles = _dist.current_plan().tile_params(op, path_of(args[0]),
                                                 shape_bucket)
        if tiles:
            fn = functools.partial(fn, **tiles)
    if not _obs_state.on:
        return fn(*args)
    prof = _profiler()
    words, nbytes = cost(*args)
    t0 = time.perf_counter() if prof.active else 0.0
    out = fn(*args)
    prof.record(op, path or path_of(args[0]), words, nbytes,
                out=out if prof.active else None, t0=t0)
    return out


# -- public ops ----------------------------------------------------------------

def _into(fn, out):
    """`fn` writing its result into `out` when one is given."""
    return fn if out is None else functools.partial(fn, out=out)


def bit_matvec(a_bits: torch.Tensor, x: torch.Tensor, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """gains [C, R] = unpack(a_bits [C, W]) @ x [W*32, R] (into `out`, an
    f32 [C, R] tensor beside the operands, when given)."""
    return _run("bit_matvec", _into(_bm.bit_matvec, out), _cost_bit_matvec, a_bits, x)


def coverage_gain(a_bits: torch.Tensor, mask: torch.Tensor, *,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """gains [C] = popcount(a_bits & ~mask) (into `out`, an int32 [C]
    tensor beside the operands, when given)."""
    return _run("coverage_gain", _into(_cg.coverage_gain, out), _cost_coverage_gain,
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
                   bounds, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """gains [C, P]: per-partition popcount(a & ~mask) over the word ranges
    of `bounds` (P+1 word offsets), into `out` (an int32 [C, P] tensor
    beside the operands) when given.

    Under a `"shard"` mesh the partitions are the fleet's shards: each mesh
    entry computes its own partitions' gains (`_partition_gain_mesh`) and
    the [C, P] columns are gathered on the first entry — integer sums, so
    bit-identical to the direct call.
    """
    bounds = tuple(int(b) for b in bounds)

    def cost(a, m):
        return _cost_partition_gain(a, m, bounds)

    fused = _dist.mesh_fused(_partition_gain_mesh)
    if fused is not None:
        def fn(a, m):
            got = fused(a, m, bounds)
            return got if out is None else out.copy_(got)
        return _run("partition_gain", fn, cost, a_bits, mask, path="mesh")

    tiles = _dist.current_plan().tile_params(
        "partition_gain", path_of(a_bits),
        _autotune.bucket("partition_gain", a_bits.shape[0], a_bits.shape[1],
                         len(bounds) - 1))
    if out is not None:
        tiles["out"] = out

    def fn(a, m):
        return _pg.partition_gain(a, m, bounds, **tiles)

    return _run("partition_gain", fn, cost, a_bits, mask)


def _partition_gain_mesh(devices, a_bits: torch.Tensor, mask: torch.Tensor,
                         bounds: tuple[int, ...]) -> torch.Tensor:
    """Each partition's AND-NOT popcount on the mesh entry that owns it.

    Entry d owns a contiguous block of partitions (`distributed.blocks`,
    the reference's padded leading axis split over the entries), so its
    operand is one contiguous copy of the block's word columns [C, w_d]
    with the block's own bounds, placed on its device, and one
    `partition_gain` launch there (the plain version on the CPU). The
    reference pads every partition to the widest and masks the padding
    with all-ones words; a per-entry column block needs no padding. The
    [C, P_d] results are gathered on the first entry, where the operands
    must lie.
    """
    if a_bits.device != devices[0] or mask.device != devices[0]:
        raise ValueError(f"partition_gain on the mesh gathers its result on "
                         f"{devices[0]}; the operands lie on {a_bits.device} "
                         f"and {mask.device}")
    _pg.check_bounds(bounds, a_bits.shape[1])
    cols = []
    for dev, own in zip(devices, _dist.blocks(len(bounds) - 1,
                                               len(devices))):
        if not own:
            continue
        lo, hi = bounds[own.start], bounds[own.stop]
        part = _pg.partition_gain(
            a_bits[:, lo:hi].contiguous().to(dev),
            mask[lo:hi].contiguous().to(dev),
            [b - lo for b in bounds[own.start:own.stop + 1]])
        cols.append(part.to(devices[0]))
    return torch.cat(cols, dim=1)


def sparse_gain(doc_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """gains [C] over -1-padded doc-id lists."""
    return _run("sparse_gain", _sg.sparse_gain, _cost_sparse_gain,
                doc_ids, mask)


def match_batch(postings: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """AND of postings rows per query over one tier (-1 tokens skipped)."""
    return tier_match(postings, postings, None, tokens)
