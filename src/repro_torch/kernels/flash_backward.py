"""flash_backward: the gradient of `flash_attention` with respect to q, k
and v — CUDA kernel wrappers and their routing rule.

Two kernels, by `route`, decided from the operands before any launch:
- `csrc/flash_backward_tc.cu` when the forward went through
  `flash_prefill` (bf16, Sq > 1, 16-byte aligned, D in (64, 128, 256)) and
  saved each row's log-sum-exp (`lse`): bf16 wgmma, P and dS rounded to
  bf16 before the products that take them, a dq kernel and a dK/dV kernel
  beside a pass that pairs lse with delta = rowsum(dO * o); at D = 256 a
  dK/dV CTA owns 64 keys and each warpgroup half of D. Plain version
  `ref.flash_backward_tc`.
- `csrc/flash_backward.cu` for everything else (f32, D in (8, 16, 32),
  no saved lse): FlashAttention-2's backward on the CUDA cores in f32
  (row statistics, dK/dV per key block, dQ per query block). Plain version
  `ref.flash_attention_bwd`. A head dim below 8 is zero-padded to 8 with
  the true D's scale (`pad_head_dim`, as the forward pads it) and the
  gradients sliced back; a batch past the grid's z limit is launched in
  slices.
Neither uses float atomics, so a run repeats its bits. Neither replaces a
Pallas kernel: the reference has no Pallas backward and differentiates its
pure-JAX `chunked_attention`. CPU tensors take the routed kernel's plain
version; CUDA tensors launch the routed kernel or raise. The gradients come
back in f32; the autograd Function in `flash_attention` casts them to the
operands' dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, flash_prefill, ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # flash_backward.cu's instantiations
MIN_HEAD_DIM = HEAD_DIMS[0]             # smaller head dims are zero-padded to it (both kernels)
TC_HEAD_DIMS = (64, 128, 256)           # flash_backward_tc.cu's
DTYPES = (torch.float32, torch.bfloat16)
INT32_MAX = 2 ** 31 - 1


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the tensor-core pair takes these operands, given the
    forward's lse: the forward went through `flash_prefill` (its `takes`)
    and D is in TC_HEAD_DIMS, which holds every head dim `flash_prefill`
    takes."""
    return q.shape[3] in TC_HEAD_DIMS and flash_prefill.takes(q, k, v)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          lse: torch.Tensor | None) -> str:
    """The kernel a CUDA call with these operands launches: the tensor-core
    pair where it `takes` them and the forward's lse is given; else the
    CUDA-core kernel."""
    return "flash_backward_tc" if lse is not None and takes(q, k, v) else "flash_backward"


def pad_head_dim(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each [B, S, H, D] tensor, D < MIN_HEAD_DIM, as a fresh contiguous
    copy with zero columns up to MIN_HEAD_DIM: q·k and p·v gain exact zero
    terms, so a kernel given the true D's scale computes the unpadded
    function, and the gradients' padded columns are sliced off."""
    return tuple(torch.nn.functional.pad(t, (0, MIN_HEAD_DIM - t.shape[3])).contiguous()
                 for t in ts)


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
                   window: int | None = None, softcap: float | None = None,
                   lse: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in f32 of attention (causal or not) at q_offset 0 over
    all Skv keys: q/o/do [B, S, Hq, D], k/v [B, Skv, Hkv, D]; `lse` [B, Hq, S] f32,
    the forward's per-row log-sum-exp in base 2 (`flash_prefill`'s
    `lse_out`), or None."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hkv == 0 \
            or hq % hkv or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}")
    if lse is not None and lse.shape != (b, hq, s):
        raise ValueError(f"lse must be [B, Hq, S] = {(b, hq, s)}, got {tuple(lse.shape)}")
    kernel = route(q, k, v, lse)
    kw = dict(causal=causal, window=window, softcap=softcap)
    if _build.on_cpu(q, k, v, o, do, lse):
        if kernel == "flash_backward_tc":
            return ref.flash_backward_tc(q, k, v, o, do, lse, **kw)
        return ref.flash_attention_bwd(q, k, v, o, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor (or every operand on the "
                         f"CPU), got device {q.device}")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        _check(t, name, q)
    if d not in HEAD_DIMS and not 0 < d < MIN_HEAD_DIM:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS} "
                         f"nor below {MIN_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if max(s, skv) > INT32_MAX - 64:
        raise ValueError("flash_backward's positions must fit in int32")
    if kernel == "flash_backward_tc":
        return _backward_tc(q, k, v, o, do, lse, **kw)
    scale = 1.0 / math.sqrt(d)
    if d < MIN_HEAD_DIM:
        q, k, v, o, do = pad_head_dim(q, k, v, o, do)
    grads = _backward_cuda_core(q, k, v, o, do, scale=scale, **kw)
    return grads if d == q.shape[3] else tuple(g[..., :d] for g in grads)


def _backward_cuda_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        window: int | None, softcap: float | None, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`csrc/flash_backward.cu` on checked operands, scores times `scale`:
    one launch per slice of at most `_build.MAX_GRID_Z` batch entries."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, hq, d), **f32)
    dk = torch.empty((b, skv, hkv, d), **f32)
    dv = torch.empty((b, skv, hkv, d), **f32)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    row_lse = torch.empty((b, hq, s), **f32)
    delta = torch.empty((b, hq, s), **f32)
    strides = (ctypes.c_int64 * 24)(*(x for t in (q, k, v, o, do, dq, dk, dv)
                                      for x in t.stride()[:3]))
    for b0 in range(0, b, _build.MAX_GRID_Z):
        part = [t[b0:b0 + _build.MAX_GRID_Z]
                for t in (q, k, v, o, do, dq, dk, dv, row_lse, delta)]
        _build.launch("flash_backward", q.device, lambda lib, stream:
                      lib.flash_backward_launch(
                          *(t.data_ptr() for t in part), part[0].shape[0], s, skv, hq,
                          hkv, d, strides, skv, kernel_window(window, s),
                          0.0 if softcap is None else float(softcap), scale,
                          int(causal), int(q.dtype == torch.bfloat16), stream))
    return dq, dk, dv


def _backward_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, *, causal: bool,
                 window: int | None, softcap: float | None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`csrc/flash_backward_tc.cu` on operands that `route` sent there and
    `flash_backward` checked."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != s:
        raise ValueError(f"flash_backward_tc takes Skv = S, got {k.shape[1]} and {s}")
    if not flash_prefill.aligned(o, do):
        raise ValueError("flash_backward_tc needs o and do 16-byte aligned like q, k, v")
    if lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 tensor on {q.device}, got "
                         f"{lse.dtype} on {lse.device}")
    if s * (hq // hkv) > INT32_MAX:
        raise ValueError("flash_backward_tc's rows must fit in int32")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, hq, d), **f32)
    dk = torch.empty((b, s, hkv, d), **f32)
    dv = torch.empty((b, s, hkv, d), **f32)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    stats = torch.empty((b, hq, -(-s // 64) * 64, 2), **f32)
    strides = (ctypes.c_int64 * 15)(*(x for t in (q, k, v, o, do) for x in t.stride()[:3]))
    _build.launch("flash_backward_tc", q.device, lambda lib, stream:
                  lib.flash_backward_tc_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, s, hq, hkv, d, strides,
                      kernel_window(window, s),
                      0.0 if softcap is None else float(softcap), int(causal), stream))
    return dq, dk, dv
