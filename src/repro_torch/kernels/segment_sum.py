"""segment_sum: each segment's rows added in a fixed order — the CUDA kernel's
wrapper, its index plan, and the two autograd Functions EGNN's edges go
through.

Kernel: `csrc/segment_sum.cu`. It replaces no Pallas kernel: the reference
sums EGNN's edge messages onto the nodes with XLA's `jax.ops.segment_sum`
(`repro.models.egnn._layer_messages`), and the gradients of its edge gathers
are segment sums too. On the card, PyTorch's `index_add_` adds with float
atomics in an order that changes from run to run; this kernel adds each
segment's rows left to right in the plan's order (the valid rows sorted by
segment, stably: ascending row order within a segment), so a training step
repeats its bits and the result equals a sequential `index_add_` on the CPU
bit for bit. CPU tensors take the plain version `ref.segment_sum`; CUDA
tensors launch the kernel or raise.

`SegmentPlan` is built once per index (an edge list's `dst` or `src`, a
batch's graph ids) and reused by every call over it, forward and backward.
`sum_rows` (a segment sum whose backward is a gather) and `gather_rows`
(`table[index]` whose backward is a segment sum by the same plan) keep
every CUDA scatter off the path: neither direction reaches `index_add_`,
`scatter_add_` or `index_put_(accumulate=True)`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build, ref

THREAD_MAX_F = 8    # rows this wide or narrower take a thread a segment, wider a warp


def route(f: int) -> str:
    """The kernel's parallel layout for F columns: "thread" or "warp"."""
    return "thread" if f <= THREAD_MAX_F else "warp"


def segment_sum(rows: torch.Tensor, perm: torch.Tensor, offsets: torch.Tensor,
                out0: torch.Tensor | None = None) -> torch.Tensor:
    """f32 rows [E, F], int32 perm [M] (row ids in segment order), int32
    offsets [N+1], f32 out0 [N, F] or None -> f32 [N, F]:
    out[n] = out0[n] + sum of rows[perm[i]] for i in [offsets[n], offsets[n+1]),
    added left to right (the kernel's contract; no autograd)."""
    if _build.on_cpu(rows, perm, offsets, out0):
        return ref.segment_sum(rows, perm, offsets, out0)
    if _build.on_meta(rows, perm, offsets, out0):
        # the dry run: the result's shape (the plain version's loop runs
        # over the segments' lengths, which meta tensors do not hold)
        return torch.empty((offsets.shape[0] - 1, rows.shape[1]), dtype=rows.dtype,
                           device="meta")
    _build.require(rows, "rows", torch.float32, 2)
    _build.require(perm, "perm", torch.int32, 1, rows.device)
    _build.require(offsets, "offsets", torch.int32, 1, rows.device)
    n, f = offsets.shape[0] - 1, rows.shape[1]
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{rows.shape[0]} rows: perm is int32")
    if out0 is not None:
        _build.require(out0, "out0", torch.float32, 2, rows.device)
        if tuple(out0.shape) != (n, f):
            raise ValueError(f"out0 has shape {tuple(out0.shape)}, expected {(n, f)}")
    out = torch.empty((n, f), dtype=torch.float32, device=rows.device)
    if n == 0 or f == 0:
        return out
    _build.launch("segment_sum", rows.device, lambda lib, stream: lib.segment_sum_launch(
        rows.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
        None if out0 is None else out0.data_ptr(), out.data_ptr(), n, f,
        int(route(f) == "thread"), stream))
    return out


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Where each of E rows goes among N segments.

    index: int32 [E], each row's segment (0 where the row is not valid);
    valid: bool [E], or None when every row is; perm: int32 [M], the valid
    rows in segment order, ascending within a segment; offsets: int32
    [N+1], segment n's rows are perm[offsets[n]:offsets[n+1]]."""
    index: torch.Tensor
    valid: torch.Tensor | None
    perm: torch.Tensor
    offsets: torch.Tensor

    @property
    def n_segments(self) -> int:
        return self.offsets.shape[0] - 1

    def counts(self) -> torch.Tensor:
        """int32 [N]: each segment's number of valid rows (exact)."""
        return self.offsets[1:] - self.offsets[:-1]


def plan(index: torch.Tensor, n_segments: int,
         valid: torch.Tensor | None = None) -> SegmentPlan:
    """The plan of `index` [E] (int) over `n_segments`, on its device; a row
    is valid where `valid` says (default: index >= 0). A stable sort of the
    valid rows by segment (the others last) and a search for each segment's
    first row: no atomics."""
    if n_segments >= 2 ** 31 or index.shape[0] >= 2 ** 31:
        raise ValueError("segments and rows must fit int32")
    idx = index.to(torch.int32)
    if valid is None:
        valid = idx >= 0
    key = torch.where(valid, idx, torch.full_like(idx, n_segments))
    keys, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_segments + 1, dtype=torch.int32, device=idx.device)
    offsets = torch.searchsorted(keys, bounds).to(torch.int32)
    # on meta (the dry run: shapes only) every row counts as valid
    m = idx.shape[0] if offsets.is_meta else int(offsets[-1])
    every = m == idx.shape[0]
    return SegmentPlan(index=torch.where(valid, idx, torch.zeros_like(idx)),
                       valid=None if every else valid,
                       perm=order[:m].to(torch.int32).contiguous(),
                       offsets=offsets.contiguous())


def _gather(table: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """table[index], zero rows where the plan's rows are not valid (a plain
    gather: indexing's forward adds nothing)."""
    out = table.index_select(0, p.index)
    if p.valid is not None:
        out = torch.where(p.valid[:, None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))
    return out


class SumRows(torch.autograd.Function):
    """out = out0 + the segment sums of rows by the plan; the backward is a
    gather of the output's gradient (and out0's is that gradient)."""

    @staticmethod
    def forward(ctx, rows, out0, p):
        ctx.p = p
        ctx.has_out0 = out0 is not None
        return segment_sum(rows.contiguous(), p.perm, p.offsets,
                           None if out0 is None else out0.contiguous())

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _gather(g, ctx.p), (g if ctx.has_out0 else None), None


class GatherRows(torch.autograd.Function):
    """table[index] (zero rows where not valid); the backward is the segment
    sum of the gradient's rows by the same plan."""

    @staticmethod
    def forward(ctx, table, p):
        ctx.p = p
        return _gather(table, p)

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        return segment_sum(g.contiguous(), p.perm, p.offsets), None


def sum_rows(rows: torch.Tensor, p: SegmentPlan,
             out0: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable `segment_sum` of rows [E, F] by the plan `p`, added on
    `out0` [N, F] (None: zeros)."""
    return SumRows.apply(rows, out0, p)


def gather_rows(table: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Differentiable table[index] of table [N, F] by the plan `p`, zero
    rows where the plan's rows are not valid."""
    return GatherRows.apply(table, p)
