"""flash_attention: GQA attention with a causal mask, a sliding window, a
logit softcap, a query offset and a valid KV length — CUDA kernel wrapper.

Kernels: `csrc/flash_attention_short.cu`, `csrc/flash_decode.cu`,
`csrc/flash_prefill.cu` and `csrc/flash_attention.cu` (together they
replace the Pallas `repro.kernels.flash_attention._flash_attention_impl`).
CPU tensors take the plain version `ref.flash_attention`; CUDA tensors
launch a kernel or raise. Four routes, by `route`, from the operands before
any launch:
- short key ranges (Skv <= SHORT_MAX_S, D <= SHORT_MAX_D, f32 or bf16: the
  plans `short_plan` gives) of a forward of Sq > 1, or of any Sq at a head
  dim below 8, go to the one-pass `flash_attention_short` (the recsys
  blocks: BST at S 21 and D 32 / 8 = 4, BERT4Rec at S 200 and D 32). A CTA
  owns whole (batch, kv head) units with all their keys on chip, each
  row's softmax over its whole row; D below 8 is read in place and any
  batch is one launch. At D <= 8 and Skv <= 32 it runs on the CUDA cores in
  f32, one thread a row (plain version `ref.flash_attention`); otherwise
  on the TF32 tensor cores with split operands (`ref.flash_attention_short`
  is its arithmetic);
- one query position (Sq = 1, the decode step) at D >= 8 goes to the
  split-KV kernel of `flash_decode`;
- Sq > 1 in bf16 with D in (64, 128, 256) and 16-byte aligned operands to
  the wgmma kernel of `flash_prefill`;
- everything else (f32 past 256 keys or at D > 32, unaligned views) to the
  tile kernel, which multiplies on the TF32 tensor cores with split
  operands (`ref.flash_tile` is its arithmetic) in the tiles `tile_plan`
  gives. A head dim below 8 past 256 keys goes there too, zero-padded to 8
  with the softmax scale of the true D: zero columns add exact zeros to
  every split-TF32 product, so the padded call computes the unpadded
  function. A batch past the grid's z limit (65535) is launched in slices.
All read q, k and v in their [B, S, H, D] layout through their strides, so a
decode step passes one layer's slice of the KV cache as it lies, with
`kv_len` = the filled length.

When autograd wants a gradient of q, k or v, the call goes through
`Attention`, a `torch.autograd.Function` whose forward is the routed
forward above and whose backward is `flash_backward`, itself routed by
`flash_backward.route` to one of three kernels: on the card, a forward
that takes `flash_prefill` (D in (64, 128, 256)) also writes each row's
log-sum-exp (`saves_lse`), and its gradient takes the bf16 tensor-core pair
`csrc/flash_backward_tc.cu`; a gradient without it over at most
`flash_backward.SHORT_MAX_S` keys at D <= 32 (the recsys blocks, D 4
included, whose forward takes `flash_attention_short` and writes no lse)
takes the one-pass `csrc/flash_backward_short.cu`; the rest (f32 or
unaligned at longer sequences, D 64 and above without an lse) takes the
CUDA-core `csrc/flash_backward.cu`. On the CPU the forward is the plain one
and saves no lse, so the gradient is `ref.flash_attention_bwd`. The
contract is the training forward's: q_offset 0, every key valid and Sq =
Skv, causal (the LM) or not (the recsys blocks), with or without a window
and a softcap; a gradient asked for outside it (a decode step, kv_len <
Skv) raises NotImplementedError.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, flash_backward, flash_decode, flash_prefill, ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)
STAGES = 2                              # K/V tiles in the tile kernel's ring
SMEM_PER_BLOCK = 232448                 # the opt-in shared memory of a block


class TilePlan(NamedTuple):
    """The tile kernel's tiling for one head dim and dtype: `rows` (position,
    group head) rows per CTA in groups of 16, each group taken by one warp
    or, at D = 256, by two warps that split D (`warps` a CTA); K/V tiles
    of `keys` keys in a ring of `stages`; row strides in 4-byte words of Q
    (f32) and of K and V (in their dtype), padded so that the fragment loads
    are free of bank conflicts; `smem` bytes of shared memory a CTA, the
    paired warps' score exchange included."""
    rows: int
    warps: int
    keys: int
    stages: int
    q_words: int
    k_words: int
    v_words: int
    smem: int


def _padded(words: int, modulus: int, rest: int) -> int:
    """The least stride >= words that is `rest` mod `modulus`."""
    return words + (rest - words) % modulus


def tile_plan(d: int, dtype: torch.dtype) -> TilePlan:
    """The plan that `csrc/flash_attention.cu` is built with (its `Layout`),
    which the launch checks: a lane loads 4 consecutive Q or K elements (2
    at D = 8), L words, and a stride of 4L mod 8L words puts the lanes of a
    load phase on distinct banks; V loads take a stride of 4 mod 8 words."""
    size = torch.empty((), dtype=dtype).element_size()
    kc = 4 if d >= 16 else 2
    lk = max(1, kc * size // 4)
    k_words = _padded(d * size // 4, 8 * lk, 4 * lk)
    q_words = _padded(d, 8 * kc, 4 * kc)
    v_words = _padded(d * size // 4, 8, 4)
    rows, keys = ref.TILE_ROWS, ref.TILE_KEYS
    halves = 2 if d == 256 else 1
    warps = rows // 16 * halves
    exchange = warps * 16 * keys if halves == 2 else 0   # 16 x keys scores a warp
    smem = 4 * (rows * q_words + STAGES * keys * (k_words + v_words) + exchange)
    return TilePlan(rows, warps, keys, STAGES, q_words, k_words, v_words, smem)


SHORT_MAX_S = flash_backward.SHORT_MAX_S   # flash_attention_short's keys at most
SHORT_MAX_D = flash_backward.SHORT_MAX_D   # and head dim
TINY_MAX_S = 32            # its CUDA-core route: keys
TINY_MAX_D = 8             # and head dim at most
TINY_MAX_THREADS = 256     # threads a CTA of that route at most (in turns past it)
TINY_MAX_ROWS = {4: 3, 8: 1}   # rows a thread of that route at most, by its head width
TINY_SMEM = 48 * 1024      # bytes of K and V a CTA of that route stages at most
FWD_WARPS = 8              # warps a CTA of its tensor-core route
FWD_ROW_TILES = 2          # 16-row tiles a warp of that route is given, where units allow
FWD_SMEM = SMEM_PER_BLOCK // 2   # its bytes a CTA at most: two CTAs an SM


class ShortPlan(NamedTuple):
    """flash_attention_short's tiling for one call: `tiny`, the CUDA-core
    route, with K and V rows zero-filled to `dp` in {4, 8} words in shared
    memory and `rows` (position, head) rows a thread (positions ceil(Sq /
    rows) apart), or the tensor-core route (`rows` 16 a warp's tile), with
    heads zero-filled to `dp` in {8, 16, 32}, K split into rows of hi then
    lo at a stride of 8 mod 32 words, V at 4 mod 32; `units` (batch, kv head)
    units a CTA (a multiple or a divisor of Hkv), `threads` a CTA, `smem`
    bytes of shared memory a CTA (K and V of its units)."""
    tiny: bool
    dp: int
    rows: int
    units: int
    threads: int
    smem: int


def _words(w: int, rest: int) -> int:
    """The least stride >= w that is `rest` mod 32 words."""
    return w + (rest - w) % 32


def _ceil32(n: int) -> int:
    return -(-n // 32) * 32


def _unit_counts(hkv: int, most: int) -> list[int]:
    """Units a CTA may own, ascending: the divisors of Hkv (part of one
    batch entry) and its multiples (whole entries), up to `most`."""
    divs = [u for u in range(1, hkv + 1) if hkv % u == 0]
    return divs + [nb * hkv for nb in range(2, most // hkv + 1)]


def short_plan(sq: int, skv: int, d: int, hq: int, hkv: int,
               dtype: torch.dtype) -> ShortPlan | None:
    """The plan `csrc/flash_attention_short.cu` runs Sq query positions, Skv
    keys, head dim `d` and Hq / Hkv heads with, or None where it does not
    take the call (Skv past SHORT_MAX_S, d past SHORT_MAX_D, another dtype).
    The CUDA-core route where D <= TINY_MAX_D and Skv <= TINY_MAX_S: up to
    TINY_MAX_ROWS rows a thread (fewer at the wider head, whose registers
    they would spill), as many as leave the fewest row slots idle
    (each K and V row read from shared memory serves them all); as many
    whole batch entries a CTA as leave the fewest of its threads idle (at
    most TINY_MAX_THREADS threads, TINY_SMEM bytes), else the largest
    divisor of Hkv units that fits. Else the tensor-core route: FWD_WARPS
    warps a CTA, the fewest units that give each warp FWD_ROW_TILES row
    tiles, within FWD_SMEM (one unit where a unit alone needs more)."""
    if dtype not in DTYPES or not (1 <= d <= SHORT_MAX_D and 1 <= skv <= SHORT_MAX_S
                                   and sq >= 1 and hkv >= 1 and hq % hkv == 0):
        return None
    g = hq // hkv
    if d <= TINY_MAX_D and skv <= TINY_MAX_S:
        dp = 4 if d <= 4 else 8
        per_unit = 8 * skv * dp
        r = max(range(1, TINY_MAX_ROWS[dp] + 1), key=lambda r: (sq / (-(-sq // r) * r), r))
        slots = -(-sq // r) * g          # thread slots a unit
        entry = hkv * slots
        if entry <= TINY_MAX_THREADS and hkv * per_unit <= TINY_SMEM:
            fits = [nb for nb in range(1, TINY_MAX_THREADS // entry + 1)
                    if nb * hkv * per_unit <= TINY_SMEM]
            nb = max(fits, key=lambda n: (n * entry / _ceil32(n * entry), -n))
            units = nb * hkv
        else:
            units = max(u for u in _unit_counts(hkv, hkv)
                        if u == 1 or (u * per_unit <= TINY_SMEM
                                      and u * slots <= TINY_MAX_THREADS))
        return ShortPlan(True, dp, r, units, min(TINY_MAX_THREADS, _ceil32(units * slots)),
                         units * per_unit)
    rows = sq * g
    dp = 8 if d <= 8 else 16 if d <= 16 else 32
    per_unit = 4 * (-(-skv // 8) * 8) * (_words(2 * dp, 8) + _words(dp, 4))
    tiles = -(-rows // 16)
    counts = [u for u in _unit_counts(hkv, max(hkv, FWD_SMEM // per_unit))
              if u * per_unit <= FWD_SMEM] or [1]   # past 248 keys at D 32: one CTA an SM
    units = next((u for u in counts if u * tiles >= FWD_ROW_TILES * FWD_WARPS), counts[-1])
    return ShortPlan(False, dp, 16, units, FWD_WARPS * 32, units * per_unit)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call with these operands launches. No call that
    `saves_lse` takes the short kernel (it writes no lse): those have D in
    (64, 128, 256), past SHORT_MAX_D."""
    sq, d = q.shape[1], q.shape[3]
    if (sq > 1 or d < flash_backward.MIN_HEAD_DIM) and short_plan(
            sq, k.shape[1], d, q.shape[2], k.shape[2], q.dtype) is not None:
        return "flash_attention_short"
    if d < flash_backward.MIN_HEAD_DIM:
        return "flash_attention"
    if sq == 1:
        return "flash_decode"
    return "flash_prefill" if flash_prefill.takes(q, k, v) else "flash_attention"


def _require(t: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if t.dtype != q.dtype or t.dtype not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16 like q, got {t.dtype}")
    if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]):
        raise ValueError(f"{name} needs a contiguous last dimension and "
                         f"strides that are multiples of 4, got {t.stride()}")
    if t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"{name} is not aligned to 4 elements")


def saves_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether `Attention` asks its forward for each row's log-sum-exp: a
    call off the CPU's plain path whose gradient the tensor-core pair takes
    (`flash_backward.takes`), so its forward routes to `flash_prefill`."""
    return not _build.on_cpu(q, k, v) and flash_backward.takes(q, k, v)


class Attention(torch.autograd.Function):
    """`flash_attention` with a gradient: the routed forward, and
    `flash_backward` from the saved q, k, v, output and, where the forward
    wrote it (`saves_lse`), each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, kv_len):
        lse = (torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32,
                           device=q.device) if saves_lse(q, k, v) else None)
        out = _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                       q_offset=q_offset, kv_len=kv_len, lse_out=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_offset, kv_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, q_offset, kv_len = ctx.args
        skv = k.shape[1]
        if q_offset != 0 or (kv_len is not None and kv_len != skv) or q.shape[1] != skv:
            raise NotImplementedError(
                "flash_attention's gradient is the training forward's: q_offset 0, "
                f"kv_len = Skv = Sq; got q_offset={q_offset}, kv_len={kv_len}, "
                f"Sq={q.shape[1]}, Skv={skv}")
        if not flash_prefill.aligned(dout):   # a fresh copy is aligned
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_backward.flash_backward(q, k, v, out, dout, causal=causal,
                                                   window=window, softcap=softcap,
                                                   lse=lse)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D] in q's dtype.

    `q_offset` is the absolute position of q[:, 0]; keys at or past `kv_len`
    (default Skv) do not exist. `window` None is global attention. Through
    `Attention` when autograd wants a gradient of q, k or v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return Attention.apply(q, k, v, causal, window, softcap, q_offset, kv_len)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, kv_len=kv_len)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int | None, softcap: float | None,
             q_offset: int, kv_len: int | None,
             lse_out: torch.Tensor | None = None) -> torch.Tensor:
    """The routed forward: the plain version on the CPU, else a kernel.
    `lse_out` (only where `saves_lse`) goes to `flash_prefill`."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {skv}]")
    if _build.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len)
    if _build.on_meta(q, k, v):
        # the dry run: every route's shapes by the f32 plain version
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor (or every operand on the "
                         f"CPU), got device {q.device}")
    kernel = route(q, k, v)
    if lse_out is not None and kernel != "flash_prefill":
        raise ValueError(f"lse_out is written by flash_prefill only; this call "
                         f"routes to {kernel}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    if kernel == "flash_attention_short":
        return _short(q, k, v, **kw)
    if 0 < d < flash_backward.MIN_HEAD_DIM:
        q, k, v = flash_backward.pad_head_dim(q, k, v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require(t, name, q)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS} "
                         f"nor below {flash_backward.MIN_HEAD_DIM}")
    if kernel == "flash_decode":
        return flash_decode.flash_decode(q, k, v, **kw)
    if kernel == "flash_prefill":
        return flash_prefill.flash_prefill(q, k, v, lse_out=lse_out, **kw)
    out = _tile(q, k, v, scale=1.0 / math.sqrt(d), **kw)
    return out if out.shape[3] == d else out[..., :d]


def _tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          window: int | None, softcap: float | None, q_offset: int, kv_len: int,
          scale: float) -> torch.Tensor:
    """The tile kernel on checked operands, with scores times `scale`: one
    launch per slice of at most `_build.MAX_GRID_Z` batch entries."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    smem = tile_plan(d, q.dtype).smem
    for b0 in range(0, b, _build.MAX_GRID_Z):
        qs, ks, vs, os_ = (t[b0:b0 + _build.MAX_GRID_Z] for t in (q, k, v, out))
        _build.launch("flash_attention", q.device, lambda lib, stream:
                      lib.flash_attention_launch(
                          qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), os_.data_ptr(),
                          qs.shape[0], sq, hq, hkv, d, *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], kv_len, int(q_offset),
                          -1 if window is None else int(window),
                          0.0 if softcap is None else float(softcap), scale,
                          int(causal), int(q.dtype == torch.bfloat16), smem, stream))
    return out


def _short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
           window: int | None, softcap: float | None, q_offset: int,
           kv_len: int) -> torch.Tensor:
    """`csrc/flash_attention_short.cu` on operands that `route` sent there:
    one launch, the true D read in place and written at the true D, the
    plan `short_plan` gives (the launch checks it against its own)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for t, name in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} like q, got {t.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1 and d > 1:
            raise ValueError(f"{name} needs a contiguous last dimension, got {t.stride()}")
    if abs(int(q_offset)) > 2 ** 30:
        raise ValueError(f"q_offset {q_offset} past the kernel's int range")
    plan = short_plan(sq, skv, d, hq, hkv, q.dtype)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
    win = -1 if window is None else min(int(window), 2 ** 30)
    _build.launch("flash_attention_short", q.device, lambda lib, stream:
                  lib.flash_attention_short_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
                      hq, hkv, d, strides, kv_len, int(q_offset), win,
                      0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(d),
                      int(causal), int(q.dtype == torch.bfloat16), int(plan.tiny), plan.dp,
                      plan.rows, plan.units, plan.threads, plan.smem, stream))
    return out
