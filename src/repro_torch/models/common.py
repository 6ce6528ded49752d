"""Shared model building blocks, the counterparts of `repro.models.common`.

`rms_norm` and `rope` compute in f32 and cast back to the input's dtype, as
the reference does. `attention` is the one attention entry the transformer
calls: the reference's `chunked_attention` (which its Pallas kernel mirrors
on the TPU), here `ops.flash_attention`, differentiable through its
`Attention` function. `chunked_cross_entropy` is the training loss's
sequence-chunked softmax cross-entropy.
"""
from __future__ import annotations

import torch
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
