"""Mesh construction for the launchers, the tests and the dry run.

The port's counterpart of `repro.launch.mesh`. Functions, not module-level
constants: importing this module touches no device.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh_context import Mesh
from repro_torch.distributed.plan import spread
from repro_torch.distributed.sharding import P


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16 x 16 `("data", "model")`, or
    2 x 16 x 16 `("pod", "data", "model")` with `multi_pod`, as an abstract
    mesh whose entries are `torch.device("meta")`. That mesh is TPU chips
    (256 or 512 of them) and has no card counterpart: the dry run
    (`launch.dryrun`) reads its axes and sizes to count each entry's bytes,
    and nothing is placed on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return Mesh(axes, (torch.device("meta"),) * n, shape)


def make_host_mesh(model: int = 1, device_type: str = "cuda",
                   n_devices: int | None = None) -> Mesh:
    """A `(n // model, model)` `("data", "model")` mesh over the visible
    devices of `device_type` (`n`: their count, or `n_devices` entries
    spread round-robin over them: four entries on one card, or four CPU
    entries with `device_type="cpu"`, as `shard_mesh` spreads them)."""
    n = len(spread(1, device_type)) if device_type == "cpu" else \
        torch.cuda.device_count()
    n = n if n_devices is None else int(n_devices)
    devs = spread(n, device_type)
    model = min(model, n)
    if n % model:
        raise ValueError(f"{n} entries do not split into a model axis of {model}")
    return Mesh(("data", "model"), devs, (n // model, model))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def batch_spec(mesh: Mesh) -> P:
    return P(data_axes(mesh))
