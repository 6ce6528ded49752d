"""Gradient compression for the trainer, the counterpart of the first layer
of `repro.distributed.compression`: an error-feedback transformation
(EF/EF21-style) of the gradient tree, by int8 quantisation or top-k
sparsification, whose residual lives in the train state. It reproduces the
convergence behaviour of a compressed all-reduce on one device.

`quantized_psum` is the reference's wire format, an int8 all-reduce, on the
port's one-controller mesh: it takes each entry's tensor and sums them on
the first entry.
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


def quantized_psum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The int8 all-reduce of the reference's `quantized_psum`, over the
    entries' tensors `parts` (one each, any devices): one grid for all,
    scale = max over entries of (max|x| / 127 + 1e-12); each entry rounded
    to int8 on it; the int8 values summed as int32 in entry order on the
    first entry's device; the sum times scale, f32. 4x fewer bytes than an
    f32 sum would move between devices."""
    dev = parts[0].device
    scale = torch.stack([(torch.max(torch.abs(x.float())) / 127.0 + 1e-12).to(dev)
                         for x in parts]).max()
    total = None
    for x in parts:
        q = torch.clamp(torch.round(x.float() / scale.to(x.device)), -127, 127).to(torch.int8)
        q = q.to(dev).to(torch.int32)
        total = q if total is None else total + q
    return total.to(torch.float32) * scale
