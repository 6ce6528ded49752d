"""Shared model building blocks, the counterparts of `repro.models.common`.

`rms_norm` and `rope` compute in f32 and cast back to the input's dtype, as
the reference does. `attention` is the one attention entry the transformer
calls: the reference's `chunked_attention` (which its Pallas kernel mirrors
on the TPU), here `ops.flash_attention`, differentiable through its
`Attention` function. `chunked_cross_entropy` is the training loss's
sequence-chunked softmax cross-entropy. `dense_init`, `mlp_params` and
`mlp` are the plain initialiser and MLP of the recsys towers and heads
(the reference keeps the MLP pair in `repro.models.egnn` as `_mlp_params`
and `_mlp`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D], positions: [S] or [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs               # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                       # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape: tuple[int, ...], in_axis: int = -2) -> torch.Tensor:
    """f32 N(0, 1) / sqrt(fan_in) on `gen`'s device, fan_in = shape[in_axis]
    (the reference's distribution, not its numbers: the generators differ)."""
    return torch.randn(shape, generator=gen, device=gen.device).div_(math.sqrt(shape[in_axis]))


def mlp_params(gen: torch.Generator, dims: tuple[int, ...]) -> list[dict]:
    """[{"w": dense_init [d_i, d_i+1], "b": zeros [d_i+1]}] for each layer."""
    return [{"w": dense_init(gen, (dims[i], dims[i + 1])),
             "b": torch.zeros(dims[i + 1], device=gen.device)}
            for i in range(len(dims) - 1)]


def mlp(params: list[dict], x: torch.Tensor, act=F.silu,
        last_act: bool = False) -> torch.Tensor:
    """x @ w + b for each layer, `act` (silu) between layers and, with
    `last_act`, after the last."""
    for i, layer in enumerate(params):
        x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
        if i < len(params) - 1 or last_act:
            x = act(x)
    return x


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest entries along the last axis
    in `jax.lax.top_k`'s order: values descending, and at equal values the
    lower index first (-inf included; -0.0 ranks below +0.0, as in XLA's
    total order). `torch.topk` promises
    no order at ties, so it runs on unique int64 keys: the value's f32 bits
    mapped to an order-preserving int32, times 2^32, plus 2^32 - 1 - index.
    NaN is not ordered."""
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k {k} outside [0, {n}]")
    if n >= 2 ** 32:
        raise ValueError(f"top_k takes at most 2^32 - 1 entries a row, got {n}")
    bits = x.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    keys = ordered * 2 ** 32 + (2 ** 32 - 1 - idx)
    top = torch.topk(keys, k, dim=-1, sorted=True).values
    ids = 2 ** 32 - 1 - (top & (2 ** 32 - 1))
    return torch.gather(x, -1, ids), ids


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              cap: float | None = None, q_offset: int = 0,
              kv_len: int | None = None) -> torch.Tensor:
    """GQA attention, q [B, Sq, Hq, D] over k/v [B, Skv, Hkv, D] (the
    reference's `chunked_attention` contract)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=cap, q_offset=q_offset, kv_len=kv_len)


def _xent_chunk(h: torch.Tensor, unembed: torch.Tensor, y: torch.Tensor,
                cap: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of -log p(label), count) over one chunk's valid labels."""
    logits = softcap(h.float() @ unembed.float(), cap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.clamp(min=0).long()[..., None])[..., 0]
    valid = y >= 0
    return (torch.sum(torch.where(valid, logz - gold, torch.zeros_like(logz))),
            torch.sum(valid))


def chunked_cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, *, cap: float | None = None,
                          chunk: int = 512) -> torch.Tensor:
    """Mean softmax cross-entropy of hidden [B, S, D] @ unembed [D, V] (f32,
    the final softcap `cap` applied) against labels [B, S] (-100 ignored),
    `chunk` positions at a time. Under autograd each chunk is checkpointed:
    its f32 logits [B, chunk, V] are made again in the backward instead of
    kept (at internlm2-1.8b, 4 x 4096 tokens, the kept logits would be 6.1
    GB), so only one chunk's logits live at a time either way."""
    remat = torch.is_grad_enabled() and (hidden.requires_grad or unembed.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s0 in range(0, hidden.shape[1], chunk):
        args = (hidden[:, s0:s0 + chunk], unembed, labels[:, s0:s0 + chunk], cap)
        t, c = (checkpoint(_xent_chunk, *args, use_reentrant=False,
                           preserve_rng_state=False) if remat else _xent_chunk(*args))
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1)
