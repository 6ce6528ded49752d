"""repro_torch.distributed — the fleet's shard mesh and its fused paths.

  * `mesh_context` — the ambient mesh (`use_mesh`, `current_mesh`): code
    never threads a mesh through calls; `model_axis_in` names a `"model"`
    mesh, over which the MoE FFN shards its experts;
  * `plan` — `ExecutionPlan` binds the ambient mesh and its `"shard"` axis
    (`shard_fused`: the cluster router serves fused) and looks up the
    autotuner's tiles (`tile_params`);
    `shard_mesh` builds a mesh over the visible devices; `mesh_fused` is
    the gate `ops.partition_gain` goes through.

  * `compression` — the trainer's gradient compression (int8 or top-k
    with error feedback) and `quantized_psum`, the int8 sum over a mesh's
    entries; `data_axes` names a mesh's data-parallel axes (EGNN splits its
    edges over them).

  * `plan` also holds the solvers' `"model"`-axis fusion: `place` cuts a
    matrix into its entries' (data rows x model words) blocks once;
    `axis_rank`, `owner_select`, `owner_row` and `model_gains` compute on
    those blocks and combine on the first entry;
  * `sharding` — the port's PartitionSpec `P`, `add_fsdp`,
    `opt_state_specs`, and each entry's block shape and bytes under a spec
    (`entry_bytes`), which the dry run records; `shard_hint` (in
    `mesh_context`) is an identity: the port places no activation by spec.
"""
from repro_torch.distributed.mesh_context import (      # noqa: F401
    Mesh, current_mesh, data_axes, model_axis_in, shard_hint, use_mesh)
from repro_torch.distributed.plan import (              # noqa: F401
    MODEL_AXIS, SHARD_AXIS, ExecutionPlan, axis_rank, blocks, current_plan,
    mesh_fused, model_gains, owner_row, owner_select, place, shard_mesh)

__all__ = [
    "ExecutionPlan", "MODEL_AXIS", "Mesh", "SHARD_AXIS", "axis_rank", "blocks",
    "current_mesh", "current_plan", "data_axes", "mesh_fused", "model_axis_in",
    "model_gains", "owner_row", "owner_select", "place", "shard_hint", "shard_mesh",
    "use_mesh",
]
