"""flash_attention: GQA attention with a causal mask, a sliding window, a
logit softcap, a query offset and a valid KV length — CUDA kernel wrapper.

Kernel: `csrc/flash_attention.cu` (replaces the Pallas
`repro.kernels.flash_attention._flash_attention_impl`). CPU tensors take the
plain version `ref.flash_attention`; CUDA tensors launch a kernel or raise.
Three routes, by `route`, from the operands before any launch: one query
position (Sq = 1, the decode step) goes to the split-KV kernel of
`flash_decode`; Sq > 1 in bf16 with D in (64, 128, 256) and 16-byte aligned
operands to the wgmma kernel of `flash_prefill`; everything else (f32, the
other head dims, unaligned views) to the tile kernel, which multiplies on
the TF32 tensor cores with split operands (`ref.flash_tile` is its
arithmetic) in the tiles `tile_plan` gives. A head dim below 8 (BST's 32 /
8 = 4) also goes to the tile kernel, zero-padded to 8 with the softmax
scale of the true D: zero columns add exact zeros to every split-TF32
product, so the padded call computes the unpadded function (the TF32
`mma.sync` is 8 wide in k, so a D-4 kernel would pad inside anyway). A
batch past the grid's z limit (65535) is launched in slices. All read q, k
and v in their [B, S, H, D] layout through their strides, so a decode step passes one
layer's slice of the KV cache as it lies, with `kv_len` = the filled
length.

When autograd wants a gradient of q, k or v, the call goes through
`Attention`, a `torch.autograd.Function` whose forward is the routed
forward above and whose backward is `flash_backward`, itself routed by
`flash_backward.route` to one of three kernels: on the card, a forward
that takes `flash_prefill` (D in (64, 128, 256)) also writes each row's
log-sum-exp (`saves_lse`), and its gradient takes the bf16 tensor-core pair
`csrc/flash_backward_tc.cu`; a gradient without it over at most
`flash_backward.SHORT_MAX_S` keys at D <= 32 (the recsys blocks, D 4
included) takes the one-pass `csrc/flash_backward_short.cu`; the rest
(f32 or unaligned at longer sequences, D 64 and above without an lse)
takes the CUDA-core `csrc/flash_backward.cu`. On the CPU the forward is
the plain one and saves no lse, so the gradient is
`ref.flash_attention_bwd`. The contract is
the training forward's: q_offset 0, every key valid and Sq = Skv, causal
(the LM) or not (the recsys blocks), with or without a window and a
softcap; a gradient asked for outside it (a decode step, kv_len < Skv)
raises NotImplementedError.
"""
from __future__ import annotations

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


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call with these operands launches."""
    if q.shape[3] < flash_backward.MIN_HEAD_DIM:
        return "flash_attention"
    if q.shape[1] == 1:
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
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor (or every operand on the "
                         f"CPU), got device {q.device}")
    kernel = route(q, k, v)
    if 0 < d < flash_backward.MIN_HEAD_DIM:
        q, k, v = flash_backward.pad_head_dim(q, k, v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require(t, name, q)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not among the kernel's {HEAD_DIMS} "
                         f"nor below {flash_backward.MIN_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              kv_len=kv_len)
    if lse_out is not None and kernel != "flash_prefill":
        raise ValueError(f"lse_out is written by flash_prefill only; this call "
                         f"routes to {kernel}")
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
