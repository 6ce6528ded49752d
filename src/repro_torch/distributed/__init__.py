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
    with error feedback).

The rest of the reference's training side (`sharding`, `quantized_psum`,
the other model-axis helpers) is not part of this package yet.
"""
from repro_torch.distributed.mesh_context import (      # noqa: F401
    Mesh, current_mesh, model_axis_in, use_mesh)
from repro_torch.distributed.plan import (              # noqa: F401
    SHARD_AXIS, ExecutionPlan, blocks, current_plan, mesh_fused, shard_mesh)

__all__ = [
    "ExecutionPlan", "Mesh", "SHARD_AXIS", "blocks", "current_mesh",
    "current_plan", "mesh_fused", "model_axis_in", "shard_mesh", "use_mesh",
]
