"""The execution plan: which mesh the fleet-facing ops fan out over.

The port's counterpart of `repro.distributed.plan`. `ExecutionPlan` binds
the ambient mesh and its `"shard"` axis; `ExecutionPlan.shard_fused` says
whether the fleet-facing ops fuse: the cluster router branches on it, and
`mesh_fused` is the gate `ops.partition_gain` goes through. With a
one-entry mesh, or a mesh without the `"shard"` axis, neither fuses and
the caller takes its direct path.

`ExecutionPlan.tile_params` is the autotuner's lookup (`kernels.autotune`):
the tile a kernel dispatch passes to its wrapper for (op, path, shape
bucket). What the reference's plan also carries is absent here on purpose:
there is no kernel backend (`resolve_backend`, `placement`, `pinned`,
`REPRO_KERNEL_BACKEND`), because in the port the operands' device picks the
route (CPU tensors take the plain version, CUDA tensors the kernel). The
model-axis helpers (`owner_row`, `owner_select`, `axis_rank`) belong to the
training side.

A shard mesh is driven by one process: each entry's work is launched on
its device in turn, and results are gathered on the first entry by tensor
copies (a peer copy between cards, nothing on one card).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.distributed.mesh_context import Mesh, current_mesh

SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The bound mesh and its fleet axis.

    `shard_axis` is the fleet/partition axis (`"shard"`): with more than one
    entry, the cluster router serves each batch through
    `cluster.mesh_serve.serve_fused` and `ops.partition_gain` computes each
    partition's gains on the entry that owns it.
    """
    mesh: Mesh
    shard_axis: str | None

    @property
    def n_shard_devices(self) -> int:
        return self.mesh.size if self.shard_axis else 1

    @property
    def shard_fused(self) -> bool:
        """Fuse fleet-facing ops over the `"shard"` axis?"""
        return self.shard_axis is not None and self.n_shard_devices > 1

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
    return ExecutionPlan(
        mesh=mesh, shard_axis=SHARD_AXIS if mesh.axis == SHARD_AXIS else None)


def shard_mesh(n_devices: int | None = None,
               device_type: str = "cuda") -> Mesh:
    """A `("shard",)` mesh of `n_devices` entries spread round-robin over
    the visible devices of `device_type` (None: one entry per visible
    device). `shard_mesh(4)` is one entry per card on four cards and four
    entries on `cuda:0` on one; `shard_mesh(4, "cpu")` four CPU entries."""
    if device_type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif device_type == "cpu":
        visible = [torch.device("cpu")]
    else:
        raise ValueError(f"a shard mesh is made of 'cuda' or 'cpu' devices, "
                         f"got {device_type!r}")
    if not visible:
        raise RuntimeError(f"no visible {device_type} device for a shard "
                           "mesh; pass device_type='cpu' to run the plain "
                           "PyTorch path on the CPU")
    n = len(visible) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a shard mesh needs >= 1 entry, got {n}")
    return Mesh(SHARD_AXIS, tuple(visible[i % len(visible)]
                                  for i in range(n)))


def blocks(n_items: int, n_devices: int) -> list[range]:
    """The items each mesh entry owns: contiguous blocks of
    ceil(n_items / n_devices), the layout of the reference's leading axis
    padded to a multiple of the entries and split over them. Trailing
    entries may own fewer items, or none."""
    per = -(-n_items // n_devices)
    return [range(min(d * per, n_items), min((d + 1) * per, n_items))
            for d in range(n_devices)]


def mesh_fused(body):
    """The one mesh gate: `body` bound to the ambient shard mesh's devices,
    called as `body(devices, *args)`, or None when the plan does not fuse
    (one entry, or no `"shard"` axis): the caller then takes its direct
    path."""
    plan = current_plan()
    if not plan.shard_fused:
        return None
    devices = plan.mesh.devices

    def run(*args):
        return body(devices, *args)
    return run
