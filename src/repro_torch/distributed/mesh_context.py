"""Ambient mesh context.

The port's counterpart of `repro.distributed.mesh_context`. Code that can
fan out over several devices (the fleet's fused serve, owner-local
partition gains) asks for the ambient mesh here instead of threading one
through every call; the launcher, `chip_smoke.py` and the tests set it with
`use_mesh`. With no mesh set, `current_mesh()` is a one-entry mesh with no
`"shard"` or `"model"` axis, so every caller takes its direct path. The MoE
FFN shards its experts over a `"model"` mesh (`model_axis_in`); EGNN splits
its edges over the data axes of a larger one (`data_axes`).

A mesh is a small frozen value: one axis name and an ordered tuple of
`torch.device`s. One process drives all of them, as the reference's one
controller drives its `shard_map` programs; an entry may repeat a device
(four logical entries on `cuda:0`), and then the entries' work runs in
series on that device's stream.

The reference's `shard_hint` serves the transformer's SPMD layout and is not
ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered, one-axis list of devices."""
    axis: str
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __str__(self) -> str:
        return f"{self.axis}[{', '.join(str(d) for d in self.devices)}]"


_DEFAULT = Mesh("data", (torch.device("cpu"),))
_CURRENT: list[Mesh | None] = [None]


def current_mesh() -> Mesh:
    """The mesh set by the innermost `use_mesh`, else a one-entry mesh on
    the `"data"` axis (no fusion: callers run on their operands' device)."""
    return _CURRENT[0] if _CURRENT[0] is not None else _DEFAULT


def model_axis_in(mesh: Mesh) -> str | None:
    """`"model"` when `mesh` is a model (expert-parallel) mesh, else None."""
    return "model" if mesh.axis == "model" else None


def data_axes(mesh: Mesh | None = None) -> tuple[str, ...]:
    """The data-parallel axes of `mesh` (default: the ambient one): its axis
    unless that is `"model"`, as the reference keeps every axis but
    `"model"`."""
    mesh = current_mesh() if mesh is None else mesh
    return () if mesh.axis == "model" else (mesh.axis,)


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
