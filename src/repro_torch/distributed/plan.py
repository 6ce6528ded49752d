"""The execution plan: which mesh the fleet-facing ops and the solvers' gain
kernels fan out over.

The port's counterpart of `repro.distributed.plan`. `ExecutionPlan` binds
the ambient mesh and its role axes: the `"shard"` axis (the fleet's
shards: the cluster router serves fused and `ops.partition_gain` runs
owner-local when `shard_fused`) and the training-style `"model"` and data
axes the solvers' fusions shard over (`model_fused`: `optpes`,
`sparse_step` and the tiering cells' dense round). `mesh_fused(body, axis)`
is the one gate: it binds `body` to the mesh's devices when the mesh can
fuse over `axis`, else returns None and the caller takes its direct path.

`ExecutionPlan.tile_params` is the autotuner's lookup (`kernels.autotune`):
the tile a kernel dispatch passes to its wrapper for (op, path, shape
bucket). What the reference's plan also carries is absent here on purpose:
there is no kernel backend (`resolve_backend`, `placement`, `pinned`,
`REPRO_KERNEL_BACKEND`), because in the port the operands' device picks the
route (CPU tensors take the plain version, CUDA tensors the kernel).

One process drives a mesh. The reference's `shard_map` bodies become loops
over the entries in entry order; a collective becomes a combine on the
first entry in entry order: a sum (`psum`) of packed or float rows, a max
(`pmax`) of -1-padded id rows. A matrix sharded over the mesh is cut into
its entries' blocks once (`place`, by `sharding.block_slices`) and kept
beside the matrix while it lives; each call then gathers rows and launches
its kernels on the blocks. `axis_rank`, `owner_select` and `owner_row` are
the reference's owner-local gather primitives on those blocks.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.distributed import sharding
from repro_torch.distributed.mesh_context import Mesh, current_mesh
from repro_torch.distributed.sharding import P

SHARD_AXIS = "shard"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The bound mesh and its role axes.

    `shard_axis` is the fleet/partition axis (`"shard"`): with more than one
    entry, the cluster router serves each batch through
    `cluster.mesh_serve.serve_fused` and `ops.partition_gain` computes each
    partition's gains on the entry that owns it. `model_axis` / `data_axes`
    are the roles the solver fusions shard over: clause rows over the data
    axes, packed words over `"model"`.
    """
    mesh: Mesh
    shard_axis: str | None
    model_axis: str | None = None
    data_axes: tuple[str, ...] = ()

    @property
    def n_shard_devices(self) -> int:
        return self.mesh.shape[self.shard_axis] if self.shard_axis else 1

    @property
    def shard_fused(self) -> bool:
        """Fuse fleet-facing ops over the `"shard"` axis?"""
        return self.shard_axis is not None and self.n_shard_devices > 1

    @property
    def model_fused(self) -> bool:
        """Fuse solver gain kernels over the `"model"` axis?"""
        return self.model_axis is not None and self.mesh.size > 1

    def tile_params(self, op: str, path: str, shape_bucket) -> dict:
        """Autotuned kernel keywords for (op, path, shape bucket): how the
        kernel tiles, where the operands' device already picked which
        kernel runs. {} (the wrapper's defaults) on a cache miss, when
        `shape_bucket` is None (an untuned op), or when autotuning is
        disabled (REPRO_TORCH_KERNEL_TILES=off)."""
        if shape_bucket is None:
            return {}
        return _autotune().tile_params(op, path, shape_bucket)


@functools.cache
def _autotune():
    """`kernels.autotune`, imported on first use (the kernels import this
    package)."""
    from repro_torch.kernels import autotune
    return autotune


def current_plan() -> ExecutionPlan:
    """The plan the ambient mesh implies."""
    mesh = current_mesh()
    names = mesh.axis_names
    return ExecutionPlan(
        mesh=mesh,
        shard_axis=SHARD_AXIS if SHARD_AXIS in names else None,
        model_axis=MODEL_AXIS if MODEL_AXIS in names else None,
        data_axes=tuple(a for a in names if a not in (MODEL_AXIS, SHARD_AXIS)))


def _visible(device_type: str, what: str) -> list[torch.device]:
    if device_type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif device_type == "cpu":
        visible = [torch.device("cpu")]
    else:
        raise ValueError(f"a {what} is made of 'cuda' or 'cpu' devices, "
                         f"got {device_type!r}")
    if not visible:
        raise RuntimeError(f"no visible {device_type} device for a {what}; "
                           "pass device_type='cpu' to run the plain PyTorch "
                           "path on the CPU")
    return visible


def spread(n: int, device_type: str = "cuda", what: str = "mesh") -> tuple[torch.device, ...]:
    """`n` mesh entries spread round-robin over the visible devices of
    `device_type`."""
    visible = _visible(device_type, what)
    if n < 1:
        raise ValueError(f"a {what} needs >= 1 entry, got {n}")
    return tuple(visible[i % len(visible)] for i in range(n))


def shard_mesh(n_devices: int | None = None,
               device_type: str = "cuda") -> Mesh:
    """A `("shard",)` mesh of `n_devices` entries spread round-robin over
    the visible devices of `device_type` (None: one entry per visible
    device). `shard_mesh(4)` is one entry per card on four cards and four
    entries on `cuda:0` on one; `shard_mesh(4, "cpu")` four CPU entries."""
    n = len(_visible(device_type, "shard mesh")) if n_devices is None \
        else int(n_devices)
    return Mesh(SHARD_AXIS, spread(n, device_type, "shard mesh"))


def blocks(n_items: int, n_devices: int) -> list[range]:
    """The items each mesh entry owns: contiguous blocks of
    ceil(n_items / n_devices), the layout of the reference's leading axis
    padded to a multiple of the entries and split over them. Trailing
    entries may own fewer items, or none."""
    per = -(-n_items // n_devices)
    return [range(min(d * per, n_items), min((d + 1) * per, n_items))
            for d in range(n_devices)]


def mesh_fused(body, axis: str = SHARD_AXIS, mesh: Mesh | None = None):
    """The one mesh gate: `body` bound to the mesh's devices, called as
    `body(devices, *args)`, or None when the mesh (the ambient one by
    default) cannot fuse over `axis` (one entry, or no such axis): the
    caller then takes its direct path. The default axis is the fleet's
    `"shard"` (the reference's default is `"model"`: its solvers are the
    gate's first callers there, the fleet's here)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh.size == 1 or axis not in mesh.axis_names:
        return None

    def run(*args):
        return body(mesh.devices, *args)
    return run


# -- the "model"-axis fusion: blocks placed once, owner-local rows -------------

@dataclasses.dataclass(frozen=True)
class Placed:
    """A matrix cut into its mesh entries' blocks: `blocks[e]` lies on
    entry e's device, `rows[e]` / `cols[e]` are the ranges of the full
    matrix it holds."""
    blocks: tuple[torch.Tensor, ...]
    rows: tuple[range, ...]
    cols: tuple[range, ...]


_PLACED: WeakTensorKeyDictionary = WeakTensorKeyDictionary()


def place(mat: torch.Tensor, spec: P, mesh: Mesh) -> Placed:
    """`mat` [R, W] cut into each entry's block under `spec` on `mesh`, on
    that entry's device; made on the first call and kept while `mat` lives
    (the operands of a problem are placed once, not once a call), so `mat`
    must not be changed in place while placed (the incidence matrices never
    are: a grown corpus is a new matrix). A block that is a contiguous view
    of `mat` on the same device is not copied."""
    per = _PLACED.setdefault(mat, {})
    key = (mesh, spec)
    if key not in per:
        bl, rows, cols = [], [], []
        for e, dev in enumerate(mesh.devices):
            rs, cs = sharding.block_slices(tuple(mat.shape), spec, mesh, e)
            bl.append(_block(mat[rs, cs], dev))
            rows.append(range(rs.start, rs.stop))
            cols.append(range(cs.start, cs.stop))
        per[key] = Placed(tuple(bl), tuple(rows), tuple(cols))
    return per[key]


def _block(view: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """An entry's block: a copy on `dev`, or, where the view is contiguous
    and on `dev` already, a tensor over the same storage that does not hold
    the viewed tensor itself (the placement must not keep its key alive)."""
    same = view.device.type == dev.type and (view.device.index or 0) == (dev.index or 0)
    if not same or not view.is_contiguous():
        return view.contiguous().to(dev)
    return torch.empty(0, dtype=view.dtype, device=dev).set_(
        view.untyped_storage(), view.storage_offset(), view.shape, view.stride())


def release(mat: torch.Tensor) -> None:
    """Drop every placement of `mat` (its blocks are freed with the last
    reference)."""
    _PLACED.pop(mat, None)


def axis_rank(mesh: Mesh, axes, entry: int) -> int:
    """Row-major rank of mesh entry `entry` over `axes` (the reference's
    rank of the calling device inside a `shard_map` body)."""
    coords = mesh.coords(entry)
    rank = 0
    for ax in axes:
        rank = rank * mesh.shape[ax] + coords[ax]
    return rank


def owner_select(a: torch.Tensor, idx: torch.Tensor, rank: int, *, fill=0,
                 rows_per: int | None = None):
    """Owner-local rows `idx` (global indices) of a row-sharded local block.

    Rows this entry owns are taken from its block, the others come back as
    `fill`: combine across owners with a sum (fill=0) or a max (fill=-1 for
    padded id rows). `idx` is a 0-d or 1-d tensor on the block's device.
    `rows_per` is the layout's block height (default the block's own, as in
    the reference, whose padded blocks all have it; a trailing ceil-sized
    block here may be shorter)."""
    c_loc = a.shape[0]
    if c_loc == 0:
        return torch.full(tuple(idx.shape) + tuple(a.shape[1:]), fill,
                          dtype=a.dtype, device=a.device)
    lidx = idx - rank * (c_loc if rows_per is None else rows_per)
    inb = (lidx >= 0) & (lidx < c_loc)
    rows = a.index_select(0, lidx.clamp(0, c_loc - 1).reshape(-1))
    rows.masked_fill_(~inb.reshape(-1, *([1] * (a.dim() - 1))), fill)
    return rows.reshape(tuple(idx.shape) + tuple(a.shape[1:]))


def combine(parts: list[torch.Tensor], how: str = "sum") -> torch.Tensor:
    """The entries' results combined on the first one's device in entry
    order: a sum (`psum`) or a max (`pmax`)."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        p = p.to(dev)
        out = out + p if how == "sum" else torch.maximum(out, p)
    return out


def owner_row(mat: torch.Tensor, j, *, w_axis: str | None = None,
              ids: bool = False, mesh: Mesh | None = None) -> torch.Tensor:
    """Row `j` of a data-row-sharded matrix, from its owner's block.

    The reference lets the owning data rank slice the row locally and a
    [W]-sized collective broadcast it, where a traced-index gather would
    all-gather the whole matrix. Here each entry owner-selects row `j` of
    its block (`place(mat, P(dp, w_axis))`), the data ranks' rows are
    combined per `w_axis` slice (`ids`: -1-padded id rows, by a max; else
    packed or float rows, by a sum) and the slices are joined, on the first
    entry. The reference tells id rows by their int32 dtype from packed
    uint32 words; the port's packed words are int32 too, so the caller
    says. Off a fusing mesh it is `mat[j]`. `j`: an int or a 0-d tensor."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh_fused(lambda devs: None, MODEL_AXIS, mesh) is None:
        if isinstance(j, torch.Tensor):       # no host read of j
            return mat.index_select(0, j.reshape(1).to(mat.device))[0]
        return mat[j]
    dp = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    placed = place(mat, P(dp, w_axis), mesh)
    slices: dict[int, list[torch.Tensor]] = {}
    for e, (b, dev) in enumerate(zip(placed.blocks, mesh.devices)):
        jj = torch.as_tensor(j, device=dev)
        row = owner_select(b, jj, axis_rank(mesh, dp, e), fill=-1 if ids else 0,
                           rows_per=len(placed.rows[0]))
        slices.setdefault(placed.cols[e].start, []).append(row)
    return torch.cat([combine(v, "max" if ids else "sum").to(mesh.devices[0])
                      for _, v in sorted(slices.items())])


def model_gains(a_q: torch.Tensor, x: torch.Tensor, a_d: torch.Tensor | None = None,
                cov_d: torch.Tensor | None = None, idx: torch.Tensor | None = None,
                *, mesh: Mesh | None = None):
    """The solvers' gains over a `"model"` mesh: f partials by `bit_matvec`
    and g partials by `coverage_gain` over each entry's block of the
    (data rows x model words)-sharded `a_q` [C, Wq] and `a_d` [C, Wd].

    With `idx` None each entry computes its block's rows and the partials
    are summed over the model ranks of each data rank, then joined in row
    order ([C], out spec P(dp)). With `idx` [K] each entry owner-selects
    those rows (zero rows where it owns none) and the partials are summed
    over every entry ([K], the reference's one psum over all axes). Every
    sum runs in entry order on the first entry; f partials in f32, g
    partials as integers, cast once. Returns (fg, gg or None), on the first
    entry."""
    from repro_torch.kernels import ops      # the kernels import this package
    mesh = current_mesh() if mesh is None else mesh
    dp = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    spec = P(dp, MODEL_AXIS)
    pq = place(a_q, spec, mesh)
    pd = None if a_d is None else place(a_d, spec, mesh)
    f_parts: dict[int, list] = {}
    g_parts: dict[int, list] = {}
    for e, dev in enumerate(mesh.devices):
        rank = axis_rank(mesh, dp, e)
        key = 0 if idx is not None else pq.rows[e].start
        rq = pq.blocks[e]
        cq = pq.cols[e]
        if idx is not None:
            rq = owner_select(rq, idx.to(dev), rank, rows_per=len(pq.rows[0]))
        xe = x[cq.start * 32:cq.stop * 32].to(dev)
        f_parts.setdefault(key, []).append(ops.bit_matvec(rq, xe)[:, 0])
        if pd is not None:
            rd = pd.blocks[e]
            cd = pd.cols[e]
            if idx is not None:
                rd = owner_select(rd, idx.to(dev), rank, rows_per=len(pd.rows[0]))
            g_parts.setdefault(key, []).append(
                ops.coverage_gain(rd, cov_d[cd.start:cd.stop].to(dev)))
    first = mesh.devices[0]
    fg = torch.cat([combine(v).to(first) for _, v in sorted(f_parts.items())])
    if pd is None:
        return fg, None
    gg = torch.cat([combine(v).to(first) for _, v in sorted(g_parts.items())])
    return fg, gg.to(torch.float32)
