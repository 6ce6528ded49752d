"""flash_prefill: `flash_attention` at Sq > 1 in bf16 on Hopper's tensor
cores — CUDA kernel wrapper and its routing rule.

Kernel: `csrc/flash_prefill.cu` (replaces the Pallas
`repro.kernels.flash_attention._flash_attention_impl` for the bf16
prefill): wgmma products with f32 accumulation, K/V tiles by TMA, P·V as
two bf16 terms. CPU tensors take its plain version `ref.flash_prefill`;
CUDA tensors launch the kernel or raise. `flash_attention` routes a CUDA
call here when `takes` holds, decided from the operands before any launch.
Given `lse_out`, the kernel also writes each row's log-sum-exp in base 2,
which `flash_backward_tc` takes; the output is the same bits either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128, 256)    # the kernel's instantiations
INT32_MAX = 2 ** 31 - 1       # the kernel's positions and row counts are int32


def aligned(*ts: torch.Tensor) -> bool:
    """Every base pointer and every stride 16-byte aligned (TMA's rule; a
    meta tensor's base counts as aligned), the last dimension contiguous."""
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               for t in ts)


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The routing rule: Sq > 1, bf16 operands, D in HEAD_DIMS, and every
    base and stride 16-byte aligned."""
    return (q.shape[1] > 1 and q.shape[3] in HEAD_DIMS
            and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and aligned(q, k, v))


def kernel_window(window: int | None, q_offset: int, sq: int) -> int:
    """The window as the kernel's int32 takes it, -1 for none. A window of
    at least q_offset + sq reaches past key 0 from the last query, so it is
    none as well: no caller's window can wrap around in int32."""
    return -1 if window is None or window >= q_offset + sq else int(window)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, q_offset: int = 0,
                  kv_len: int | None = None,
                  lse_out: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] bf16 -> [B, Sq, Hq, D] bf16;
    the operands as `flash_attention` checks them. `lse_out`, an f32
    [B, Hq, Sq] contiguous tensor, receives each row's lse2 = m + log2(l)."""
    b, sq, hq, d = q.shape
    if lse_out is not None and (lse_out.dtype != torch.float32
                                or lse_out.shape != (b, hq, sq)
                                or not lse_out.is_contiguous()
                                or lse_out.device != q.device):
        raise ValueError(f"lse_out must be a contiguous float32 {(b, hq, sq)} tensor on "
                         f"{q.device}, got {lse_out.dtype} {tuple(lse_out.shape)} on "
                         f"{lse_out.device}")
    if _build.on_cpu(q, k, v):
        return ref.flash_prefill(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_len=kv_len, lse_out=lse_out)
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    if not takes(q, k, v):
        raise ValueError(f"flash_prefill takes Sq > 1, bf16, D in {HEAD_DIMS} and "
                         f"16-byte aligned operands, got {tuple(q.shape)} {q.dtype}")
    if max(sq * (hq // hkv), int(q_offset) + sq, kv_len) > INT32_MAX:
        raise ValueError("flash_prefill's rows and positions must fit in int32")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch("flash_prefill", q.device, lambda lib, stream:
                  lib.flash_prefill_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if lse_out is None else lse_out.data_ptr(),
                      b, sq, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
                      *v.stride()[:3], kv_len, int(q_offset),
                      kernel_window(window, int(q_offset), sq),
                      0.0 if softcap is None else float(softcap), int(causal),
                      stream))
    return out
