"""segment_sum: each segment's rows added in a fixed order — the CUDA kernels'
wrapper, the index plans, and the autograd Functions EGNN's edges go through.

Kernels: `csrc/segment_sum.cu`. They replace no Pallas kernel: the reference
sums EGNN's edge messages onto the nodes with XLA's `jax.ops.segment_sum`
(`repro.models.egnn._layer_messages`), and the gradients of its edge gathers
are segment sums too. On the card, PyTorch's `index_add_` adds with float
atomics in an order that changes from run to run; these kernels add each
segment's rows left to right in the plan's order (ascending row order within
a segment), so a training step repeats its bits and the result equals a
sequential `index_add_` on the CPU bit for bit. CPU tensors take the plain
version `ref.segment_sum`; CUDA tensors launch a kernel or raise.

Two routes, chosen by the plan:
- gather (`plan`): the valid rows sorted by segment, stably, into a `perm`;
  the kernel reads rows[perm[i]] and writes every segment
  (`segment_sum_launch`, launches counted as "segment_sum");
- stream (`sorted_plan`): an index already in nondecreasing order, so the
  rows lie in segment order and there is no perm; the kernel streams them
  through shared memory and sums only the plan's node range `bounds`,
  writing only there (`segment_sum_stream_launch`, "segment_sum_stream").
  EGNN lays its edges out by destination, so its sums by dst take this route
  and each edge chunk touches only its own nodes.
Within each route the layout is chosen by F (`route`): a thread a segment up
to F 8, a warp (the gather route: a half-warp with float4 loads at F % 4 ==
0, F >= 16) above it.

A plan is built once per index (an edge chunk's `dst` or `src`, a batch's
graph ids) and reused by every call over it, forward and backward. `sum_rows`
(a segment sum whose backward is a gather), `gather_rows` (`table[index]`
whose backward is a segment sum by the same plan) and `gather_pair` (two
gathers of one table whose backward sums into one tensor) keep every CUDA
scatter off the path: neither direction reaches `index_add_`, `scatter_add_` or
`index_put_(accumulate=True)`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build, ref

THREAD_MAX_F = 8    # rows this wide or narrower take a thread a segment, wider a warp
STREAM_MAX_F = 256  # the stream route's widest row (csrc/segment_sum.cu kStreamMaxF)


def route(f: int) -> str:
    """The kernels' parallel layout for F columns: "thread" or "warp"."""
    return "thread" if f <= THREAD_MAX_F else "warp"


def _half(f: int, *ts: torch.Tensor | None) -> bool:
    """The gather route's warp layout takes a half-warp and float4 loads."""
    return f >= 16 and f % 4 == 0 and _build.aligned16(*(t for t in ts if t is not None))


def segment_sum(rows: torch.Tensor, perm: torch.Tensor | None, offsets: torch.Tensor,
                out0: torch.Tensor | None = None, *, bounds: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """f32 rows [E, F], int32 perm [M] (row ids in segment order) or None
    (the rows already in segment order: the stream route), int32 offsets
    [N+1], f32 out0 [N, F] or None -> f32 [N, F]:
    out[n] = out0[n] + sum of rows[perm[i]] (or rows[i]) for i in
    [offsets[n], offsets[n+1]), added left to right (no autograd).

    The gather route writes every segment, into `out` when given (it may be
    out0) or a new tensor. The stream route needs `bounds`, int32 [2] on the
    rows' device, the node range [n_lo, n_hi): only those segments are summed
    and written, into `out` when given (in place; it may be out0), else into
    a copy of out0 (or zeros)."""
    if _build.on_cpu(rows, perm, offsets, out0, bounds, out):
        return ref.segment_sum(rows, perm, offsets, out0, bounds, out)
    n, f = offsets.shape[0] - 1, rows.shape[1]
    if _build.on_meta(rows, perm, offsets, out0, bounds, out):
        # the dry run: the result's shape (the plain version's loop runs
        # over the segments' lengths, which meta tensors do not hold)
        return out if out is not None else torch.empty((n, f), dtype=rows.dtype,
                                                       device="meta")
    stream = perm is None
    _build.require(rows, "rows", torch.float32, 2)
    _build.require(offsets, "offsets", torch.int32, 1, rows.device)
    if stream:
        if bounds is None:
            raise ValueError("the stream route (perm None) needs the plan's bounds")
        _build.require(bounds, "bounds", torch.int32, 1, rows.device)
        if f > STREAM_MAX_F:
            raise ValueError(f"the stream route takes F <= {STREAM_MAX_F}, got {f}")
    else:
        _build.require(perm, "perm", torch.int32, 1, rows.device)
        if bounds is not None:
            raise ValueError("a plan with a perm sums every segment: no bounds")
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{rows.shape[0]} rows: offsets and perm are int32")
    for t, name in ((out0, "out0"), (out, "out")):
        if t is not None:
            _build.require(t, name, torch.float32, 2, rows.device)
            if tuple(t.shape) != (n, f):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, f)}")
    if out is None:
        if not stream:
            out = torch.empty((n, f), dtype=torch.float32, device=rows.device)
        elif out0 is None:
            out = torch.zeros((n, f), dtype=torch.float32, device=rows.device)
        else:
            out = out0.clone()
    if n == 0 or f == 0:
        return out
    src = None if out0 is None else out0.data_ptr()
    if stream:
        _build.launch("segment_sum_stream", rows.device,
                      lambda lib, s: lib.segment_sum_stream_launch(
                          rows.data_ptr(), bounds.data_ptr(), offsets.data_ptr(), src,
                          out.data_ptr(), f, s))
    else:
        layout = 1 if route(f) == "thread" else 2 if _half(f, rows, out0, out) else 0
        _build.launch("segment_sum", rows.device, lambda lib, s: lib.segment_sum_launch(
            rows.data_ptr(), perm.data_ptr(), offsets.data_ptr(), src, out.data_ptr(),
            n, f, layout, s))
    return out


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Where each of E rows goes among N segments.

    index: int32 [E], each row's segment (a row that is not valid: 0 in a
    permuted plan, N - 1 in a sorted one, so its index stays
    nondecreasing); valid: bool [E], or None when every row is; offsets:
    int32 [N+1]. A permuted plan (`plan`) has perm: int32 [M], the valid rows
    in segment order, ascending within a segment; segment n's rows are
    perm[offsets[n]:offsets[n+1]], and bounds is None (every segment is
    written). A sorted plan (`sorted_plan`) has perm None: segment n's rows
    are offsets[n] .. offsets[n+1] - 1 themselves, and bounds, int32 [2] on
    the index's device, is the node range [n_lo, n_hi) its rows reach (the
    first valid row's segment to the last's, plus one)."""
    index: torch.Tensor
    valid: torch.Tensor | None
    perm: torch.Tensor | None
    offsets: torch.Tensor
    bounds: torch.Tensor | None = None

    @property
    def n_segments(self) -> int:
        return self.offsets.shape[0] - 1

    def counts(self) -> torch.Tensor:
        """int32 [N]: each segment's number of valid rows (exact)."""
        return self.offsets[1:] - self.offsets[:-1]


def plan(index: torch.Tensor, n_segments: int,
         valid: torch.Tensor | None = None) -> SegmentPlan:
    """The permuted plan of `index` [E] (int) over `n_segments`, on its
    device; a row is valid where `valid` says (default: index >= 0). A stable
    sort of the valid rows by segment (the others last) and a search for each
    segment's first row: no atomics."""
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


def sorted_plan(index: torch.Tensor, n_segments: int,
                valid: torch.Tensor | None = None) -> SegmentPlan:
    """The sorted plan of `index` [E] (int), nondecreasing over its valid
    rows, which come first: `valid` is a prefix of the rows, or None when
    every row is valid (nothing is checked). The offsets are a search for
    each segment's first row and the bounds two reductions: no sort and no
    host read, so the plan keeps its shapes on meta tensors."""
    if n_segments >= 2 ** 31 or index.shape[0] >= 2 ** 31:
        raise ValueError("segments and rows must fit int32")
    idx = index.to(torch.int32)
    key = idx if valid is None else torch.where(valid, idx, torch.full_like(idx, n_segments))
    marks = torch.arange(n_segments + 1, dtype=torch.int32, device=idx.device)
    offsets = torch.searchsorted(key, marks).to(torch.int32)
    if idx.shape[0]:
        hi = torch.amax(key if valid is None else torch.where(valid, idx, -1), 0,
                        keepdim=True) + 1
        lo = torch.minimum(key[:1], hi)
        bounds = torch.cat([lo, hi]).to(torch.int32)
    else:
        bounds = torch.zeros(2, dtype=torch.int32, device=idx.device)
    last = torch.full_like(idx, max(n_segments - 1, 0))
    return SegmentPlan(index=idx if valid is None else torch.where(valid, idx, last),
                       valid=valid, perm=None, offsets=offsets.contiguous(),
                       bounds=bounds.contiguous())


def _gather(table: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """table[index], zero rows where the plan's rows are not valid (a plain
    gather: indexing's forward adds nothing; a sorted plan's index is
    nondecreasing, so it reads the table in order)."""
    out = table.index_select(0, p.index)
    if p.valid is not None:
        out = torch.where(p.valid[:, None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))
    return out


def _sum(rows: torch.Tensor, p: SegmentPlan, out0: torch.Tensor | None,
         out: torch.Tensor | None = None) -> torch.Tensor:
    return segment_sum(rows, p.perm, p.offsets, out0, bounds=p.bounds, out=out)


class SumRows(torch.autograd.Function):
    """out = out0 + the segment sums of rows by the plan; the backward is a
    gather of the output's gradient (and out0's is that gradient). In place
    on out0 when asked (EGNN's running sums over its edge chunks)."""

    @staticmethod
    def forward(ctx, rows, out0, p, inplace):
        ctx.p = p
        ctx.has_out0 = out0 is not None
        rows = rows.contiguous()
        if out0 is None:
            return _sum(rows, p, None)
        if inplace:
            ctx.mark_dirty(out0)
            return _sum(rows, p, out0, out0)
        return _sum(rows, p, out0.contiguous())

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return _gather(g, ctx.p), (g if ctx.has_out0 else None), None, None


class GatherRows(torch.autograd.Function):
    """table[index] (zero rows where not valid); the backward is the segment
    sum of the gradient's rows by the same plan."""

    @staticmethod
    def forward(ctx, table, p):
        ctx.p = p
        return _gather(table, p)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.p, None), None


class GatherPair(torch.autograd.Function):
    """(table[p's index], table[q's index]) (zero rows where not valid); the
    backward sums both gradients into one tensor, the segment sums by q and
    then p's rows added on in place, so two gathers of one table need no
    node-sized add of their gradients."""

    @staticmethod
    def forward(ctx, table, p, q):
        ctx.p, ctx.q = p, q
        return _gather(table, p), _gather(table, q)

    @staticmethod
    def backward(ctx, gp, gq):
        out = _sum(gq.contiguous(), ctx.q, None)
        return _sum(gp.contiguous(), ctx.p, out, out), None, None


def sum_rows(rows: torch.Tensor, p: SegmentPlan, out0: torch.Tensor | None = None,
             inplace: bool = False) -> torch.Tensor:
    """Differentiable `segment_sum` of rows [E, F] by the plan `p`, added on
    `out0` [N, F] (None: zeros); with `inplace`, into out0 itself (contiguous,
    not a leaf that needs a gradient), which it returns."""
    return SumRows.apply(rows, out0, p, inplace)


def gather_rows(table: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Differentiable table[index] of table [N, F] by the plan `p`, zero
    rows where the plan's rows are not valid."""
    return GatherRows.apply(table, p)


def gather_pair(table: torch.Tensor, p: SegmentPlan,
                q: SegmentPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (gather_rows(table, p), gather_rows(table, q)), whose
    backward writes one [N, F] gradient: the sums by q, then by p in place."""
    return GatherPair.apply(table, p, q)
