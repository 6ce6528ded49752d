"""flash_decode: `flash_attention` at one query position (the decode step)
on a split-KV kernel — CUDA kernel wrapper and its split plan.

Kernel: `csrc/flash_decode.cu` (replaces the Pallas
`repro.kernels.flash_attention._flash_attention_impl` at Sq = 1). At
decode the visible keys of every row form one interval [lo, hi)
(`ref.decode_keys`), so the wrapper cuts it into `plan` splits, as many as
fill the card's resident CTA slots once: one CTA per (split, KV head,
batch, row chunk) streams its keys once for the query heads of its chunk,
writes (m, l, acc) to an f32 workspace, and a second kernel merges the
splits. `flash_attention` routes every CUDA call
with Sq = 1 here after its checks; CPU tensors take `ref.flash_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

MIN_KEYS = 256         # the fewest keys a split is given, where it can


def plan(n_keys: int, ctas: int, slots: int) -> tuple[int, int]:
    """(n_splits, keys_per_split) for `n_keys` visible keys when each split
    takes `ctas` CTAs (batch x KV heads x row chunks) and the card holds
    `slots` CTAs of the kernel at once: as many splits as fill the slots in
    one wave (a second, part-filled wave costs as long as a full one), no
    split under MIN_KEYS keys unless there is only one, none empty. A pure
    function of its arguments."""
    want = max(1, slots // max(1, ctas))
    return ref.split_keys(n_keys, min(want, max(1, n_keys // MIN_KEYS)))


def row_chunk(group: int) -> int:
    """Query heads per CTA (the kernel's GC): all G up to 4, else chunks of
    4, so that q and acc stay in registers at D = 256."""
    return 1 if group <= 1 else 2 if group == 2 else 4


class Split(NamedTuple):
    """A decode call's launch: keys [lo, lo + n_keys) cut into n_splits runs
    of `per`, query heads in chunks of `gc` per CTA, `no_key` when no key
    is visible (then [0, kv_len) with every score -1e30)."""
    lo: int
    n_keys: int
    per: int
    n_splits: int
    gc: int
    no_key: bool


def split_plan(batch: int, hq: int, hkv: int, kv_len: int, q_offset: int,
               causal: bool, window: int | None, slots: int) -> Split:
    """The launch of a call with these shapes when the card holds `slots`
    CTAs of the split kernel at once."""
    lo, hi = ref.decode_keys(kv_len, q_offset, causal, window)
    no_key = lo >= hi
    if no_key:
        lo, hi = 0, kv_len
    g = hq // hkv
    gc = row_chunk(g)
    n_splits, per = plan(hi - lo, batch * hkv * -(-g // gc), slots)
    return Split(lo, hi - lo, per, n_splits, gc, no_key)


@functools.lru_cache(maxsize=None)
def resident_ctas(index: int, d: int, bf16: bool, gc: int) -> int:
    """How many CTAs of the split kernel for (d, type, gc) CUDA device
    `index` holds at once: its SMs times the occupancy of one SM."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.lib().flash_decode_ctas_per_sm(d, int(bf16), gc,
                                                     ctypes.byref(per_sm))
    if code != 0:
        raise RuntimeError(f"flash_decode occupancy query failed (code {code})")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * max(1, per_sm.value)


def launch_plan(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                window: int | None = None, q_offset: int = 0,
                kv_len: int | None = None) -> Split:
    """The launch that `flash_decode` makes for these CUDA operands."""
    b, _, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    slots = resident_ctas(index, d, q.dtype == torch.bfloat16, row_chunk(hq // hkv))
    return split_plan(b, hq, hkv, skv if kv_len is None else int(kv_len),
                      int(q_offset), causal, window, slots)


def vec16(*ts: torch.Tensor) -> bool:
    """True when every row start of every operand is 16-byte aligned, so the
    kernel reads it with 16-byte loads (else with 8-byte ones)."""
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
               for t in ts)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 softcap: float | None = None, q_offset: int = 0,
                 kv_len: int | None = None) -> torch.Tensor:
    """q [B, 1, Hq, D], k/v [B, Skv, Hkv, D] -> [B, 1, Hq, D] in q's dtype;
    the operands as `flash_attention` checks them."""
    if _build.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   kv_len=kv_len)
    if _build.on_meta(q, k, v):
        # the dry run: every route's shapes by the f32 plain version
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset, kv_len=kv_len)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if sq != 1:
        raise ValueError(f"flash_decode takes one query position, got Sq = {sq}")
    kv_len = skv if kv_len is None else int(kv_len)
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    sp = launch_plan(q, k, causal=causal, window=window, q_offset=q_offset,
                     kv_len=kv_len)
    ws = (torch.empty((b, hkv, sp.n_splits, hq // hkv, d + 2),
                      dtype=torch.float32, device=q.device)
          if sp.n_splits > 1 else None)
    _build.launch("flash_decode", q.device, lambda lib, stream:
                  lib.flash_decode_launch(
                      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      0 if ws is None else ws.data_ptr(), b, hq, hkv, d,
                      q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                      sp.lo, sp.n_keys, sp.per, sp.n_splits, sp.gc,
                      0.0 if softcap is None else float(softcap), int(sp.no_key),
                      int(q.dtype == torch.bfloat16), int(vec16(q, k, v)),
                      stream))
    return out
