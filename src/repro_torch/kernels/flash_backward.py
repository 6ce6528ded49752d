"""flash_backward: the gradient of `flash_attention` with respect to q, k
and v — CUDA kernel wrappers and their routing rule.

Three kernels, by `route`, decided from the operands' shapes and dtypes
before any launch:
- `csrc/flash_backward_tc.cu` when the forward went through
  `flash_prefill` (bf16, Sq > 1, 16-byte aligned, D in (64, 128, 256)) and
  saved each row's log-sum-exp (`lse`): bf16 wgmma, P and dS rounded to
  bf16 before the products that take them, a dq kernel and a dK/dV kernel
  beside a pass that pairs lse with delta = rowsum(dO * o); at D = 256 a
  dK/dV CTA owns 64 keys and each warpgroup half of D. Plain version
  `ref.flash_backward_tc`.
- `csrc/flash_backward_short.cu` for every other call with Skv up to
  SHORT_MAX_S keys and D up to 32, any D below 8 included (`short_plan`
  gives its tiling; the recsys blocks' BST and BERT4Rec gradients): one
  pass, a CTA owning whole (batch, kv head) units with all their keys on
  chip, each row's softmax over its whole row; a head dim below 8 is read
  in place, and any batch is one launch. At D <= 8 and Skv <= 32 (BST) it
  runs on the CUDA cores in f32, one thread a row (plain version
  `ref.flash_attention_bwd`); otherwise every product runs on the TF32
  tensor cores with split operands (its arithmetic is
  `ref.flash_backward_short`).
- `csrc/flash_backward.cu` for the rest (longer sequences, D of 64 and
  above without a saved lse, f32): FlashAttention-2's backward on the CUDA
  cores in f32 (row statistics, dK/dV per key block, dQ per query block).
  Plain version `ref.flash_attention_bwd`. A head dim below 8 is
  zero-padded to 8 with the true D's scale (`pad_head_dim`, as the forward
  pads it) and the gradients sliced back; a batch past the grid's z limit
  is launched in slices.
None uses float atomics, so a run repeats its bits. None replaces a Pallas
kernel: the reference has no Pallas backward and differentiates its
pure-JAX `chunked_attention`. CPU tensors take `ref.flash_backward_tc`
where the tensor-core pair is routed and `ref.flash_attention_bwd`
elsewhere, as the forward takes `ref.flash_attention`; CUDA tensors launch
the routed kernel or raise. The gradients come back in f32; the autograd
Function in `flash_attention` casts them to the operands' dtype.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, flash_prefill, ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # flash_backward.cu's instantiations
MIN_HEAD_DIM = HEAD_DIMS[0]             # smaller head dims are zero-padded to it (both kernels)
TC_HEAD_DIMS = (64, 128, 256)           # flash_backward_tc.cu's
DTYPES = (torch.float32, torch.bfloat16)
INT32_MAX = 2 ** 31 - 1
SHORT_MAX_S = 256       # flash_backward_short's keys at most
SHORT_MAX_D = 32        # and head dim
SHORT_KV_ITEMS = 2      # its (unit, two 16-key tiles, dK or dV) items a warp owns at most
SHORT_WARPS = 8         # warps a CTA of its tensor-core route
TINY_MAX_S = 32         # its CUDA-core route: keys,
TINY_MAX_D = 8          # head dim
TINY_THREADS = 128      # and rows of a CTA, one thread a row, at most
SMEM_PER_BLOCK = 232448


class ShortPlan(NamedTuple):
    """flash_backward_short's tiling for one call. `tiny`: the CUDA-core
    route (D <= TINY_MAX_D, Skv <= TINY_MAX_S, one thread a row): heads
    zero-filled to `dp` in {4, 8}, `s_pad` = Skv, `rows` = S * G a unit,
    `units` units of a CTA of TINY_THREADS threads, P and dS rows of
    `p_words` (odd) words. Else the tensor-core route: heads zero-filled to
    `dp` in {8, 16, 32} in shared memory, keys padded to `s_pad` (16-key
    tiles), rows taken `rows` at a time (16-row tiles), `units` (batch, kv
    head) units and `warps` warps a CTA; row strides in words of Q, dO, o,
    K and V (`q_words`) and of the [rows, keys] P and dS (`p_words`), each
    8 mod 32. `smem`: bytes of shared memory a CTA."""
    tiny: bool
    dp: int
    s_pad: int
    rows: int
    units: int
    warps: int
    q_words: int
    p_words: int
    smem: int


def _words8(w: int) -> int:
    """The least stride >= w that is 8 mod 32 words."""
    return w + (8 - w) % 32


def _short_smem(dp: int, s_pad: int, rows: int, units: int) -> int:
    """Bytes a CTA of the tensor-core route: K and V [s_pad], Q, dO and o
    [rows] at the head-dim stride, S-then-P-then-dQ and dP-then-dS [rows,
    s_pad], delta [rows], for each unit (the kernel's `smem_bytes`)."""
    q, p = _words8(dp), _words8(s_pad)
    return 4 * units * (2 * s_pad * q + 3 * rows * q + 2 * rows * p + rows)


def _tiny_smem(dp: int, s: int, rows: int, units: int, p_words: int) -> int:
    """Bytes a CTA of the CUDA-core route: K and V [s, dp], Q and dO
    [rows, dp], P and dS [rows, p_words] for each unit (the kernel's
    `tiny_smem_bytes`)."""
    return 4 * units * (2 * s * dp + 2 * rows * dp + 2 * rows * p_words)


def short_plan(s: int, d: int, g: int, dtype: torch.dtype) -> ShortPlan | None:
    """The plan `csrc/flash_backward_short.cu` runs Skv = `s` keys, head
    dim `d` and `g` query heads a kv head with, or None where it does not
    take the call (s past SHORT_MAX_S, d past SHORT_MAX_D, another dtype).
    The CUDA-core route where D <= 8, Skv <= 32 and a unit's S * G rows fit
    a CTA, as many units as fit its threads; else the tensor-core route:
    SHORT_WARPS warps a CTA, 64 rows a group where they fit, fewer for long
    units; as many units as fill 64 rows, as the warps' dK/dV items
    allow."""
    if dtype not in DTYPES or not (1 <= d <= SHORT_MAX_D and 1 <= s <= SHORT_MAX_S
                                   and g >= 1):
        return None
    if d <= TINY_MAX_D and s <= TINY_MAX_S and s * g <= TINY_THREADS:
        dp, rows = (4 if d <= 4 else 8), s * g
        units, p_words = TINY_THREADS // rows, s | 1
        return ShortPlan(True, dp, s, rows, units, TINY_THREADS // 32, dp, p_words,
                         _tiny_smem(dp, s, rows, units, p_words))
    dp = 8 if d <= 8 else 16 if d <= 16 else 32
    s_pad = -(-s // 16) * 16
    warps = SHORT_WARPS
    rows = min(-(-(s * g) // 16) * 16, 64)
    while rows > 16 and _short_smem(dp, s_pad, rows, 1) > SMEM_PER_BLOCK:
        rows -= 16
    pairs = -(-s_pad // 32)   # pairs of 16-key tiles a unit
    units = max(1, min(64 // rows, SHORT_KV_ITEMS * warps // (2 * pairs)))
    smem = _short_smem(dp, s_pad, rows, units)
    if smem > SMEM_PER_BLOCK or 2 * units * pairs > SHORT_KV_ITEMS * warps:
        return None
    return ShortPlan(False, dp, s_pad, rows, units, warps, _words8(dp), _words8(s_pad),
                     smem)


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
    short-sequence kernel where `short_plan` takes Skv, D, G and the dtype;
    else the CUDA-core kernel."""
    if lse is not None and takes(q, k, v):
        return "flash_backward_tc"
    hkv = k.shape[2]
    if hkv > 0 and short_plan(k.shape[1], q.shape[3], q.shape[2] // hkv,
                              q.dtype) is not None:
        return "flash_backward_short"
    return "flash_backward"


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
    if _build.on_meta(q, k, v, o, do, lse):
        return ref.flash_attention_bwd(q, k, v, o, do, **kw)   # the dry run: shapes
    if _build.on_cpu(q, k, v, o, do, lse):
        if kernel == "flash_backward_tc":
            return ref.flash_backward_tc(q, k, v, o, do, lse, **kw)
        return ref.flash_attention_bwd(q, k, v, o, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor (or every operand on the "
                         f"CPU), got device {q.device}")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        _check(t, name, q)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if kernel == "flash_backward_short":
        return _backward_short(q, k, v, o, do, **kw)
    if d not in HEAD_DIMS and not 0 < d < MIN_HEAD_DIM:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS} "
                         f"nor below {MIN_HEAD_DIM}")
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


def _backward_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                    window: int | None, softcap: float | None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`csrc/flash_backward_short.cu` on operands that `route` sent there
    and `flash_backward` checked: one launch, the true D's scale, no
    padding copies; the launch checks `short_plan`'s plan against its own
    layout."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    plan = short_plan(skv, d, hq // hkv, q.dtype)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, hq, d), **f32)
    dk = torch.empty((b, skv, hkv, d), **f32)
    dv = torch.empty((b, skv, hkv, d), **f32)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    strides = (ctypes.c_int64 * 24)(*(x for t in (q, k, v, o, do, dq, dk, dv)
                                      for x in t.stride()[:3]))
    _build.launch("flash_backward_short", q.device, lambda lib, stream:
                  lib.flash_backward_short_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s,
                      skv, hq, hkv, d, strides, int(plan.tiny), plan.dp, plan.s_pad,
                      plan.rows, plan.units, plan.warps, plan.p_words,
                      kernel_window(window, s),
                      0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(d),
                      int(causal), int(q.dtype == torch.bfloat16), plan.smem, stream))
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
