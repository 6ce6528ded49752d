"""Ambient mesh context.

The port's counterpart of `repro.distributed.mesh_context`. Code that can
fan out over several devices (the fleet's fused serve, owner-local
partition gains, the solvers' `"model"`-axis gains) asks for the ambient
mesh here instead of threading one through every call; the launcher,
`chip_smoke.py` and the tests set it with `use_mesh`. With no mesh set,
`current_mesh()` is a one-entry mesh with no `"shard"` or `"model"` axis,
so every caller takes its direct path. The MoE FFN shards its experts over
a `"model"` mesh (`model_axis_in`); EGNN splits its edges over the data
axes of a larger one (`data_axes`).

A mesh is a small frozen value: named axes with a shape, laid out
row-major over an ordered tuple of `torch.device`s, as `jax.make_mesh`
lays its devices out (`Mesh(("data", "model"), devs, (2, 2))`: entry
2 * d + m is data rank d, model rank m). `Mesh("shard", devs)` is the
one-axis mesh over every entry. One process drives all of them, as the
reference's one controller drives its `shard_map` programs; an entry may
repeat a device (four logical entries on `cuda:0`), and then the entries'
work runs in series on that device's stream. A mesh of `meta` entries
describes a mesh the process does not hold (the dry run's production
mesh, `launch.mesh.make_production_mesh`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of shape `dims`, laid out row-major over `devices`.

    `axis` is one name or a tuple of names; `dims` defaults to one axis over
    every device. `axis_names`, `shape` (name -> size) and `size` read as
    the reference's `jax.sharding.Mesh` attributes do."""
    axis: str | tuple[str, ...]
    devices: tuple[torch.device, ...]
    dims: tuple[int, ...] | None = None

    def __post_init__(self):
        names = (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)
        dims = (len(self.devices),) if self.dims is None else tuple(int(d) for d in self.dims)
        if len(dims) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one size per distinct axis name, got "
                             f"axes {names} and sizes {dims}")
        if math.prod(dims) != len(self.devices):
            raise ValueError(f"a {dims} mesh has {math.prod(dims)} entries, got "
                             f"{len(self.devices)} devices")
        object.__setattr__(self, "axis", names[0] if len(names) == 1 else names)
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,) if isinstance(self.axis, str) else self.axis

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, entry: int) -> dict[str, int]:
        """Entry `entry`'s rank on each axis (row-major layout)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.dims)):
            entry, out[name] = divmod(entry, n)
        return {name: out[name] for name in self.axis_names}

    def __str__(self) -> str:
        axes = self.axis if isinstance(self.axis, str) else \
            "x".join(f"{a}:{n}" for a, n in self.shape.items())
        return f"{axes}[{', '.join(str(d) for d in self.devices)}]"


_DEFAULT = Mesh("data", (torch.device("cpu"),))
_CURRENT: list[Mesh | None] = [None]


def current_mesh() -> Mesh:
    """The mesh set by the innermost `use_mesh`, else a one-entry mesh on
    the `"data"` axis (no fusion: callers run on their operands' device)."""
    return _CURRENT[0] if _CURRENT[0] is not None else _DEFAULT


def model_axis_in(mesh: Mesh) -> str | None:
    """`"model"` when `mesh` has a model (expert-parallel) axis, else None."""
    return "model" if "model" in mesh.axis_names else None


def data_axes(mesh: Mesh | None = None) -> tuple[str, ...]:
    """The data-parallel axes of `mesh` (default: the ambient one): every
    axis but `"model"`, as the reference keeps them."""
    mesh = current_mesh() if mesh is None else mesh
    return tuple(a for a in mesh.axis_names if a != "model")


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make `mesh` the ambient mesh inside the block; the previous one is
    restored on exit."""
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev


def shard_hint(x: torch.Tensor, *entries) -> torch.Tensor:
    """`x` unchanged. The reference pins the transformer's residual stream
    to token sharding here (`with_sharding_constraint`) so that XLA's SPMD
    partitioner does not bounce it between layouts; the port places no
    activation by spec (a mesh's work is launched entry by entry), so there
    is nothing to pin. `entries` is the reference's PartitionSpec, kept at
    its call sites."""
    return x
