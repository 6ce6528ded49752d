"""E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844), the counterpart
of `repro.models.egnn`.

Message passing as the reference's: gather by edge -> message MLP -> segment
sums onto the nodes; the coordinates move equivariantly, x_i += mean over
incoming edges of (x_i - x_j) * phi_x(m_ij). The gathers and sums go through
`kernels.segment_sum` (`gather_pair`, `sum_rows`), whose sums add each
node's rows in the plan's order on either device (`csrc/segment_sum.cu` on
the card), forward and backward, so a training step repeats its bits and a
resumed run equals an uninterrupted one. One `EdgePlan` per batch serves
every layer: each mesh entry's edges stably sorted by dst (invalid edges
last), then a permuted plan by src for each chunk.

Batch layout (the reference's): node_feat [N, F] f32, coords [N, 3] f32,
edges [2, E] int32 (src, dst; -1 padded), labels [N] int32 (-100 pad) or
graph_ids [N] + targets [G].

The edge rows lie in destination order, so every sum by dst is a sorted plan
(`segment_sum.sorted_plan`: the kernel streams the rows, no gather) and each
node adds its incoming edges in ascending original edge order, as the
reference's sum does. Edges are taken in contiguous chunks of
`cfg.edge_chunk` in that order; a chunk covers a contiguous node range and
its sums continue the running sums in place over that range only, so the
chunks add the same rows in the same order as one sum would, bit for bit
(only the MLP rows, computed in GEMMs of another height, may round
otherwise). The sums by src (the gradients of the src gathers) follow the
sorted row order, the same on either device. With more than one chunk each
chunk's edge rows are checkpointed and recomputed in the backward, and the
sums sit outside the checkpoint, so neither a chunk's tensors nor the
running sums are kept: at ogb_products' 61.9M edges one [E, 64] f32 tensor
is 15.8 GB, a chunk's saved tensors about 2.1 KB an edge. Each layer is
checkpointed, as the reference's `jax.checkpoint`.

Under `use_mesh(mesh)` whose axis is a data axis (`data_axes`: any but
`"model"`), with more than one entry and E % entries == 0 (the reference's
condition), the edges split into contiguous blocks, one per entry; h and x
are copied to each entry, and the entries' (agg, xup) are summed on the
first entry in entry order: the reference's psum over its data axes, placed
as `models.embedding` places its row shards. Any other mesh takes the
direct path.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import mesh_context
from repro_torch.kernels import segment_sum as S
from repro_torch.models import common


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    task: str = "node_class"       # node_class | graph_reg
    coord_agg_clip: float = 100.0  # stability clamp on coordinate updates
    dtype: str = "float32"
    edge_chunk: int = 1 << 22      # edges a chunk (the port's; see the module doc)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(gen: torch.Generator, cfg: EGNNConfig) -> dict:
    """The reference's tree: embed, layers [phi_e, phi_x, phi_h], readout, on
    `gen`'s device (its distributions, not its numbers)."""
    dh = cfg.d_hidden

    def layer():
        return {"phi_e": common.mlp_params(gen, (2 * dh + 1, dh, dh)),
                "phi_x": common.mlp_params(gen, (dh, dh, 1)),
                "phi_h": common.mlp_params(gen, (2 * dh, dh, dh))}

    return {"embed": common.mlp_params(gen, (cfg.d_feat, dh)),
            "layers": [layer() for _ in range(cfg.n_layers)],
            "readout": common.mlp_params(gen, (dh, dh, cfg.n_classes))}


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A contiguous run of edges in dst order on one device: its sorted plan
    by dst and its permuted plan by src (both with the edge valid only where
    src >= 0 and dst >= 0)."""
    dst: S.SegmentPlan
    src: S.SegmentPlan


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """A batch's edges as mesh entries (device, chunks), and each node's
    in-degree over the valid edges (exact)."""
    entries: tuple[tuple[torch.device, tuple[Chunk, ...]], ...]
    deg: torch.Tensor


def edge_plan(edges: torch.Tensor, n_nodes: int, cfg: EGNNConfig) -> EdgePlan:
    """The plan of edges [2, E] over n_nodes under the ambient mesh: each
    entry's contiguous block of edges stably sorted by dst, invalid edges
    last, then cut into chunks."""
    mesh = mesh_context.current_mesh()
    e = edges.shape[1]
    if mesh_context.data_axes(mesh) and mesh.size > 1 and e % mesh.size == 0:
        step = e // mesh.size
        spans = [(r * step, (r + 1) * step, dev) for r, dev in enumerate(mesh.devices)]
    else:
        spans = [(0, e, edges.device)]
    entries, deg = [], None
    for lo, hi, dev in spans:
        blk = edges[:, lo:hi].to(dev)
        valid = (blk[0] >= 0) & (blk[1] >= 0)
        dst, order = torch.sort(torch.where(valid, blk[1], n_nodes), stable=True)
        src, valid = blk[0][order], valid[order]
        chunks = []
        for c0 in range(0, hi - lo, cfg.edge_chunk) or [0]:
            c = slice(c0, c0 + cfg.edge_chunk)
            by_src = S.plan(src[c], n_nodes, valid[c])
            # every row of the chunk is valid where its src plan keeps no mask
            chunks.append(Chunk(dst=S.sorted_plan(dst[c], n_nodes, by_src.valid), src=by_src))
            counts = chunks[-1].dst.counts().to(edges.device)
            deg = counts if deg is None else deg + counts
        entries.append((dev, tuple(chunks)))
    return EdgePlan(entries=tuple(entries), deg=deg.to(torch.float32))


def _edge_rows(lp: dict, h, x, ch: Chunk, cfg: EGNNConfig):
    """One chunk's edge messages m [C, dh] and coordinate updates [C, 3]."""
    # the gathered rows are temporaries: each [C, 64] pair is freed once
    # concatenated, before the MLP runs
    dx = torch.sub(*S.gather_pair(x, ch.dst, ch.src))
    dist2 = torch.sum(dx * dx, dim=-1, keepdim=True)
    m = common.mlp(lp["phi_e"], torch.cat([*S.gather_pair(h, ch.dst, ch.src), dist2], dim=-1),
                   last_act=True)
    if ch.dst.valid is not None:
        m = torch.where(ch.dst.valid[:, None], m, torch.zeros((), dtype=m.dtype,
                                                              device=m.device))
    coef = torch.clamp(common.mlp(lp["phi_x"], m), -cfg.coord_agg_clip, cfg.coord_agg_clip)
    return m, dx * coef


def _layer(lp: dict, h, x, plan: EdgePlan, cfg: EGNNConfig):
    parts = []
    for dev, chunks in plan.entries:
        hh, xx = h.to(dev), x.to(dev)
        agg = xup = None          # the chunks' rows added on in place, in dst order
        for ch in chunks:
            if len(chunks) > 1 and torch.is_grad_enabled():
                m, upd = checkpoint(_edge_rows, lp, hh, xx, ch, cfg, use_reentrant=False)
            else:
                m, upd = _edge_rows(lp, hh, xx, ch, cfg)
            agg = S.sum_rows(m, ch.dst, agg, inplace=True)
            xup = S.sum_rows(upd, ch.dst, xup, inplace=True)
        parts.append((agg, xup))
    agg, xup = parts[0]
    for a, u in parts[1:]:                  # the psum, in entry order
        agg, xup = agg + a.to(agg.device), xup + u.to(xup.device)
    agg, xup = agg.to(h.device), xup.to(h.device)
    x = x + xup * (1.0 / torch.clamp(plan.deg, min=1.0))[:, None]
    h = h + common.mlp(lp["phi_h"], torch.cat([h, agg], dim=-1))
    return h, x


def forward(params: dict, batch: dict, cfg: EGNNConfig):
    """(node embeddings [N, dh], coords' [N, 3])."""
    h = common.mlp(params["embed"], batch["node_feat"].to(cfg.adtype))
    x = batch["coords"].to(cfg.adtype)
    plan = edge_plan(batch["edges"], h.shape[0], cfg)
    for lp in params["layers"]:
        if torch.is_grad_enabled():
            h, x = checkpoint(_layer, lp, h, x, plan, cfg, use_reentrant=False)
        else:
            h, x = _layer(lp, h, x, plan, cfg)
    return h, x


def loss_fn(params: dict, batch: dict, cfg: EGNNConfig):
    """node_class: masked cross-entropy and accuracy over labels >= 0;
    graph_reg: MSE of each graph's mean-pooled first logit. The gold logit
    is picked by a one-hot product (its backward is no scatter)."""
    h, _ = forward(params, batch, cfg)
    logits = common.mlp(params["readout"], h).float()               # [N, C]
    if cfg.task == "node_class":
        labels = batch["labels"]
        valid = labels >= 0
        y = torch.clamp(labels, min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        classes = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(logits * (y[:, None] == classes).to(logits.dtype), dim=-1)
        n_valid = torch.clamp(valid.sum(), min=1)
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        loss = torch.sum(torch.where(valid, logz - gold, zero)) / n_valid
        acc = torch.sum(valid & (torch.argmax(logits, dim=-1) == y)) / n_valid
        return loss, {"xent": loss, "acc": acc}
    gp = S.plan(batch["graph_ids"], batch["targets"].shape[0])
    pooled = S.sum_rows(logits[:, :1], gp)
    pred = pooled[:, 0] / torch.clamp(gp.counts().to(torch.float32), min=1.0)
    loss = torch.mean((pred - batch["targets"]) ** 2)
    return loss, {"mse": loss}


def serve_step(params: dict, batch: dict, cfg: EGNNConfig):
    """Inference: f32 class logits (or predictions) for every node, and the
    moved coordinates."""
    h, x = forward(params, batch, cfg)
    return common.mlp(params["readout"], h).float(), x
