"""Gradient compression for the trainer, the counterpart of the first layer
of `repro.distributed.compression`: an error-feedback transformation
(EF/EF21-style) of the gradient tree, by int8 quantisation or top-k
sparsification, whose residual lives in the train state. It reproduces the
convergence behaviour of a compressed all-reduce on one device.

The reference's wire format, `quantized_psum` (an int8 all-reduce inside a
data-parallel shard_map), waits with the rest of the training side of
`distributed/`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01     # fraction of entries kept per tensor


def init_error_state(cfg: CompressionConfig, params):
    if cfg.kind == "none":
        return {}
    return {"ef": tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)}


def _quant_int8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


def compress_grads(cfg: CompressionConfig, grads, err_state):
    """grads (tree) -> (compressed f32 grads, new error state)."""
    if cfg.kind == "none":
        return grads, err_state

    def one(g, e):
        acc = g.float() + e
        if cfg.kind == "int8":
            c = _quant_int8(acc)
        elif cfg.kind == "topk":
            c = _topk_mask(acc, cfg.topk_frac)
        else:
            raise ValueError(cfg.kind)
        return c, acc - c

    out = tree.map(one, grads, err_state["ef"])
    comp, ef = tree.unzip(out, 2)
    return comp, {"ef": ef}

