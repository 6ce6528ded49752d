"""flash_backward: the gradient of `flash_attention` with respect to q, k
and v — CUDA kernel wrapper.

Kernel: `csrc/flash_backward.cu`, FlashAttention-2's backward on the CUDA
cores in f32 (row statistics, then dK/dV per key block summed over the
head group, then dQ per query block; no float atomics, so a run repeats
its bits). It replaces no Pallas kernel: the reference has no Pallas
backward and differentiates its pure-JAX `chunked_attention`. CPU tensors
take the plain version `ref.flash_attention_bwd`; CUDA tensors launch the
kernel or raise. The gradients come back in f32; the autograd Function in
`flash_attention` casts them to the operands' dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)


def kernel_window(window: int | None, s: int) -> int:
    """The window as the kernel's int32 takes it, -1 for none: a window of
    at least S reaches key 0 from the last query, so it is none as well."""
    return -1 if window is None or window >= s else int(window)


def _check(t: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype or t.dtype not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16 like q, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be [B, S, H, D] with a contiguous last "
                         f"dimension, got {tuple(t.shape)} strides {t.stride()}")


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                   window: int | None = None, softcap: float | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in f32 of causal attention at q_offset 0 over all Skv
    keys: q/o/do [B, S, Hq, D], k/v [B, Skv, Hkv, D]."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hkv == 0 \
            or hq % hkv or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}")
    if _build.on_cpu(q, k, v, o, do):
        return ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor (or every operand on the "
                         f"CPU), got device {q.device}")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        _check(t, name, q)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if max(s, skv) > 2 ** 31 - 1 - 64:
        raise ValueError("flash_backward's positions must fit in int32")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, hq, d), **f32)
    dk = torch.empty((b, skv, hkv, d), **f32)
    dv = torch.empty((b, skv, hkv, d), **f32)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((b, hq, s), **f32)
    delta = torch.empty((b, hq, s), **f32)
    strides = (ctypes.c_int64 * 24)(*(x for t in (q, k, v, o, do, dq, dk, dv)
                                      for x in t.stride()[:3]))
    _build.launch("flash_backward", q.device, lambda lib, stream:
                  lib.flash_backward_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), b, s, skv, hq, hkv, d,
                      strides, skv, kernel_window(window, s),
                      0.0 if softcap is None else float(softcap), int(causal),
                      int(q.dtype == torch.bfloat16), stream))
    return dq, dk, dv
