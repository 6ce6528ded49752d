"""Mixture-of-Experts FFN with expert parallelism, the counterpart of
`repro.models.moe` (the serving path: routing, capacity dispatch, the
grouped expert GEMM and the combine).

Capacity is per expert (GShard-style): a (token, choice) pair's slot is its
rank among the pairs routed to its expert, counted in token-major [T*k]
order, and the pair is kept while that rank is below `cap_e`; a dropped
pair goes to an overflow row that is never read back. The ranks come from
a stable sort by expert, which gives the reference's one-hot cumsum's
numbers without its [T*k, E] buffer (1.0e8 entries at a 32k prefill of
kimi-k2). The grouped GEMM is `torch.bmm` over [E_local, cap_e, D], as the
reference's is an XLA einsum outside any Pallas kernel.

Expert parallelism: under `use_mesh(Mesh("model", devices))` entry r holds
experts [r*E/n, (r+1)*E/n) and computes their contribution for every token
(tokens are replicated over the axis); the partial outputs are summed on
the first entry in rank order, the reference's `psum` over `model`. One
process drives every entry, as the fleet's shard mesh does. Routing runs
once, outside the expert shards, so the parallel path and the dense oracle
route identically. A mesh without a `"model"` axis takes the direct path.

Under autograd (`transformer.loss_fn`) the dispatch needs no change:
autograd follows the writes into the slot buffer, and the overflow row,
written by every dropped pair and never read, gets a zero gradient, as the
reference's `.at[].set` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import mesh_context


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig) -> dict:
    """One layer's f32 MoE parameters on `gen`'s device, with the
    reference's shapes and scales (not its numbers: the generators differ).
    `w2` is not divided by sqrt(2L) as the dense FFN's is."""
    e, f = cfg.n_experts, cfg.d_expert
    s_in = 1.0 / math.sqrt(d_model)
    s_f = 1.0 / math.sqrt(f)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return {"gate": normal(d_model, e) * s_in,
            "w1": normal(e, d_model, f) * s_in,
            "w3": normal(e, d_model, f) * s_in,
            "w2": normal(e, f, d_model) * s_f}


def _route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x [T, D] -> (top-k experts [T, k], their renormalised probabilities
    [T, k] f32, the Switch load-balance loss)."""
    logits = (x @ params["gate"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_e = torch.topk(probs, cfg.top_k, dim=-1)
    topk_p = topk_p / topk_p.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(topk_e[:, 0], cfg.n_experts).float().mean(dim=0)
    aux = cfg.n_experts * torch.sum(me * ce)
    return topk_e, topk_p, aux


def capacity_slots(topk_e: torch.Tensor, lo: int, e_local: int, cap_e: int):
    """(slot, keep) of each (token, choice) pair, both [T, k]: a pair routed
    to a local expert (in [lo, lo + e_local)) is kept when its rank among
    that expert's pairs, in token-major order, is below `cap_e`, and its
    slot is (expert - lo) * cap_e + rank; every other pair's slot is the
    overflow row e_local * cap_e."""
    e_flat = topk_e.reshape(-1)
    local = (e_flat >= lo) & (e_flat < lo + e_local)
    e_loc = torch.where(local, e_flat - lo, torch.full_like(e_flat, e_local))
    order = torch.sort(e_loc, stable=True).indices
    # bincount by an integer scatter-add: the same counts, and shapes that
    # do not depend on the data (the dry run runs this on meta tensors)
    counts = torch.zeros(e_local + 1, dtype=e_loc.dtype, device=e_loc.device
                         ).scatter_add_(0, e_loc, torch.ones_like(e_loc))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e_flat)
    rank[order] = torch.arange(e_flat.numel(), device=e_flat.device) - starts[e_loc[order]]
    keep = local & (rank < cap_e)
    slot = torch.where(keep, e_loc * cap_e + rank, torch.full_like(e_flat, e_local * cap_e))
    return slot.reshape(topk_e.shape), keep.reshape(topk_e.shape)


def _dispatch_local(x, topk_e, topk_p, w1, w3, w2, *, cfg: MoEConfig,
                    n_ranks: int, rank: int, cap_e: int) -> torch.Tensor:
    """One entry's contribution. x [T, D]; w*: its expert shard [E_local, ...]."""
    t, d = x.shape
    e_local = cfg.n_experts // n_ranks
    slot, _ = capacity_slots(topk_e, rank * e_local, e_local, cap_e)
    # dispatch and combine one top-k slice at a time, as the reference does
    # (a pair-major [T*k, D] gather would be k times the size)
    x_buf = torch.zeros((e_local * cap_e + 1, d), dtype=x.dtype, device=x.device)
    for j in range(cfg.top_k):
        x_buf[slot[:, j]] = x
    xb = x_buf[:-1].view(e_local, cap_e, d)
    h1 = torch.bmm(xb, w1.to(x.dtype))
    h3 = torch.bmm(xb, w3.to(x.dtype))
    yb = torch.bmm(h1 * torch.sigmoid(h1) * h3, w2.to(x.dtype))     # jax.nn.silu
    y_buf = torch.cat([yb.reshape(e_local * cap_e, d), x_buf.new_zeros((1, d))])
    p_k = topk_p.to(x.dtype)
    y = torch.zeros_like(x)
    for j in range(cfg.top_k):
        y = y + y_buf[slot[:, j]] * p_k[:, j:j + 1]
    return y


def capacity(t_local: int, cfg: MoEConfig) -> int:
    """Slots per expert for `t_local` tokens: ceil(T * k * cf / E), at least 1."""
    return max(1, math.ceil(t_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> ([T, D], aux_loss). Expert-parallel over the ambient
    mesh's `"model"` axis when it has one. The port's meshes have one axis,
    so there is no data axis and every entry sees all T tokens: cap_e
    comes from T."""
    mesh = mesh_context.current_mesh()
    axis = mesh_context.model_axis_in(mesh)
    n_ranks = mesh.size if axis else 1
    assert cfg.n_experts % n_ranks == 0, (cfg.n_experts, n_ranks)

    topk_e, topk_p, aux = _route(params, x, cfg)
    cap_e = capacity(x.shape[0], cfg)
    w = (params["w1"], params["w3"], params["w2"])
    if axis is None:
        return _dispatch_local(x, topk_e, topk_p, *w, cfg=cfg, n_ranks=1,
                               rank=0, cap_e=cap_e), aux

    e_local = cfg.n_experts // n_ranks
    y = None
    for r, dev in enumerate(mesh.devices):
        shard = [a[r * e_local:(r + 1) * e_local].to(dev) for a in w]
        part = _dispatch_local(x.to(dev), topk_e.to(dev), topk_p.to(dev), *shard,
                               cfg=cfg, n_ranks=n_ranks, rank=r, cap_e=cap_e)
        y = part if y is None else y + part.to(y.device)
    return y.to(x.device), aux


def moe_apply_dense_oracle(params: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Reference: a loop over experts, no capacity dropping (tests)."""
    topk_e, topk_p, _ = _route(params, x, cfg)
    y = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h1 = x @ params["w1"][e].to(x.dtype)
        h3 = x @ params["w3"][e].to(x.dtype)
        ye = (h1 * torch.sigmoid(h1) * h3) @ params["w2"][e].to(x.dtype)
        w_e = torch.where(topk_e == e, topk_p, torch.zeros_like(topk_p)).sum(-1)
        y = y + ye * w_e[:, None].to(x.dtype)
    return y
