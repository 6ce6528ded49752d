"""Embedding tables and EmbeddingBag, the counterparts of
`repro.models.embedding`.

`lookup` gathers rows with a backward that adds each row's duplicates in
one fixed order on either device, so a training step repeats its bits
(`_gather`): on CUDA by indexing, `table[idx]`, whose backward
(`index_put_` with accumulate) sorts the indices; on the CPU by
`F.embedding`, whose backward loops over rows. Each is the other device's
counterexample: `F.embedding`'s CUDA backward (an H100, torch 2.11) and
indexing's CPU backward both gave gradients that differed from call to
call at 24576 indices into 300 rows (by up to 3.8e-6 on the card), and a
DeepFM run killed and resumed then drifted from an uninterrupted one.
Under `use_mesh(Mesh("model", devices))` the table is row-sharded:
entry r owns rows [r*V/R, (r+1)*V/R), gathers the indices that fall there
(zeros elsewhere), and the partial results are summed on the first entry
in rank order: the reference's mask + psum over `model`, placed as
`models.moe` places experts. One process drives every entry; the indices
are replicated over the axis. A mesh without a `"model"` axis takes the
direct path.

`bag_lookup` is EmbeddingBag: a gather and a masked sum (or mean) over the
bag axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh_context


def table_spec():
    """A table's PartitionSpec: rows over `"model"`."""
    from repro_torch.distributed.sharding import P
    return P("model", None)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with a bit-reproducible backward on the table's device."""
    if table.device.type == "cuda":
        return table[idx.long()]
    return F.embedding(idx, table)


def _local_lookup(table_local: torch.Tensor, idx: torch.Tensor, lo: int) -> torch.Tensor:
    """Rows [lo, lo + V_local) gathered from their shard; zeros for every
    index outside it."""
    v_local = table_local.shape[0]
    local = (idx >= lo) & (idx < lo + v_local)
    rows = _gather(table_local, (idx - lo).clamp(0, v_local - 1))
    return torch.where(local[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [V, D] (row-sharded over the ambient `"model"` mesh when there
    is one), idx [...] int32 or int64 -> [..., D] on the table's device."""
    mesh = mesh_context.current_mesh()
    if mesh_context.model_axis_in(mesh) is None:
        return _gather(table, idx)
    n = mesh.size
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} table rows do not split over {n} entries")
    v_local = table.shape[0] // n
    out = None
    for r, dev in enumerate(mesh.devices):
        part = _local_lookup(table[r * v_local:(r + 1) * v_local].to(dev), idx.to(dev),
                             r * v_local)
        out = part if out is None else out + part.to(out.device)
    return out.to(table.device)


def bag_lookup(table: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor | None = None,
               combiner: str = "sum") -> torch.Tensor:
    """EmbeddingBag: idx [B, L] (-1 pads) -> [B, D], the sum or mean of the
    valid rows (`valid` defaults to idx >= 0)."""
    rows = lookup(table, idx.clamp(min=0))                      # [B, L, D]
    if valid is None:
        valid = idx >= 0
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    out = rows.sum(dim=-2)
    if combiner == "mean":
        out = out / valid.sum(dim=-1, keepdim=True).clamp(min=1)
    return out
