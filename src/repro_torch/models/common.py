"""Shared model building blocks, the counterparts of `repro.models.common`.

`rms_norm` and `rope` compute in f32 and cast back to the input's dtype, as
the reference does. `attention` is the one attention entry the transformer
calls: the reference's `chunked_attention` (which its Pallas kernel mirrors
on the TPU), here `ops.flash_attention`.
"""
from __future__ import annotations

import torch

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
