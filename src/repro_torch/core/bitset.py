"""Packed bitset algebra over int32 words.

The port's counterpart of `repro.core.bitset`. A bitset over a universe of
size n is a `torch.int32` tensor [..., W] with W = ceil(n / 32); bit i lives
in word i >> 5 at position i & 31. The words hold the reference's uint32 bit
pattern: PyTorch's uint32 lacks `~`, `>>` and comparisons on the CPU, and
int32 has all of them with the same bits. Convert at the numpy boundary with
`to_tensor` / `to_numpy` (a `.view`, never a value cast). Padding bits
(>= n) are always zero.

The `np_*` helpers are the reference's host-side helpers, unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def n_words(n_bits: int) -> int:
    return (n_bits + WORD - 1) // WORD


# ---------------------------------------------------------------------------
# numpy (host / preprocessing) side
# ---------------------------------------------------------------------------

def np_pack(bits: np.ndarray) -> np.ndarray:
    """Pack a bool array [..., n] into uint32 words [..., ceil(n/32)]."""
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[-1]
    w = n_words(n)
    padded = np.zeros(bits.shape[:-1] + (w * WORD,), dtype=bool)
    padded[..., :n] = bits
    padded = padded.reshape(bits.shape[:-1] + (w, WORD))
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    return (padded.astype(np.uint32) * weights).sum(axis=-1, dtype=np.uint32)


def np_unpack(words: np.ndarray, n_bits: int) -> np.ndarray:
    """Unpack uint32 words [..., W] back to bool [..., n_bits]."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(WORD, dtype=np.uint32)
    bits = (words[..., :, None] >> shifts) & np.uint32(1)
    bits = bits.reshape(words.shape[:-1] + (-1,))
    return bits[..., :n_bits].astype(bool)


def np_from_indices(idx: np.ndarray, n_bits: int) -> np.ndarray:
    """Bitset [W] with bits at `idx` set."""
    out = np.zeros(n_words(n_bits), dtype=np.uint32)
    idx = np.asarray(idx, dtype=np.int64)
    np.bitwise_or.at(out, idx >> 5, (np.uint32(1) << (idx & 31).astype(np.uint32)))
    return out


def np_to_indices(words: np.ndarray, n_bits: int) -> np.ndarray:
    return np.nonzero(np_unpack(words, n_bits))[-1]


def np_popcount(words: np.ndarray) -> np.ndarray:
    return np.bitwise_count(words.astype(np.uint32)).sum(axis=-1, dtype=np.int64)


# ---------------------------------------------------------------------------
# numpy <-> torch boundary
# ---------------------------------------------------------------------------

def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits on `device`
    (always a copy: the tensor never aliases the host array)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device, copy=True)


def to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 tensor words -> uint32 numpy words with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


# ---------------------------------------------------------------------------
# torch (device) side
# ---------------------------------------------------------------------------

def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool [..., n] -> int32 [..., W] (n padded up to a word multiple)."""
    n = bits.shape[-1]
    w = n_words(n)
    pad = w * WORD - n
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], -1)
    bits = bits.reshape(bits.shape[:-1] + (w, WORD)).to(torch.int64)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return _as_int32((bits << shifts).sum(-1))


def unpack(words: torch.Tensor, n_bits: int | None = None) -> torch.Tensor:
    """Unpack int32 [..., W] -> bool [..., n_bits or 32*W]."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (-1,))
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return bits.bool()


def word_popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each word -> int64, same shape (SWAR on int64: PyTorch
    has no popcount op)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits along the last axis -> int32 [...]."""
    return word_popcount(words).sum(-1).to(torch.int32)


def count_and_not(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """popcount(a & ~mask) along the last axis: the marginal-gain primitive."""
    return popcount(a & ~mask)


def bit_get(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather bits at positions `idx` from a flat bitset `words` [W]."""
    idx = idx.to(torch.int64)
    return ((words[idx >> 5] >> (idx & 31)) & 1).bool()


def from_indices(idx: torch.Tensor, n_bits: int,
                 valid: torch.Tensor | None = None, *,
                 unique: bool = False) -> torch.Tensor:
    """Scatter-OR indices into a fresh bitset [W] on `idx`'s device.

    `valid` masks padded entries; indices whose word lies outside [0, W)
    are dropped, as the reference drops them. With `unique=False` repeated
    indices set their bit once (they are de-duplicated first); with
    `unique=True` (indices known distinct, e.g. sorted match-set lists) the
    scatter-add of distinct powers of two is their OR directly.
    """
    w = n_words(n_bits)
    idx = idx.to(torch.int64).reshape(-1)
    keep = (idx >= 0) & (idx < w * WORD)
    if valid is not None:
        keep &= valid.reshape(-1)
    out = torch.zeros(w, dtype=torch.int64, device=idx.device)
    if unique:
        # a dropped index adds 0 to word 0: no data-dependent shape, no sync
        out.index_add_(0, torch.where(keep, idx >> 5, 0),
                       torch.where(keep, torch.ones_like(idx) << (idx & 31), 0))
    else:
        idx = torch.unique(idx[keep])
        out.index_add_(0, idx >> 5, torch.ones_like(idx) << (idx & 31))
    return _as_int32(out)


def or_rows(words: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """OR-reduce a stack of bitsets (pairwise tree; empty stack -> zeros)."""
    x = words.movedim(axis, 0)
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def is_subset(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise bitset subset test a ⊆ b over the last axis (broadcasts)."""
    return torch.all((a & b) == a, dim=-1)


def pack_tokens(tokens: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Token-id rows [B, L] (-1 padded) -> packed bitsets [B, W] on their
    device; repeated ids in a row set their bit once."""
    b, ell = tokens.shape
    w = n_words(n_bits)
    t, _ = torch.sort(tokens.to(torch.int64), dim=1)
    if ell > 1:
        dup = torch.zeros_like(t, dtype=torch.bool)
        dup[:, 1:] = t[:, 1:] == t[:, :-1]
        t = torch.where(dup, -1, t)
    valid = t >= 0
    rows = torch.arange(b, device=t.device).unsqueeze(1).expand(b, ell)
    # a padding slot adds 0 to word 0: no data-dependent shape, no sync
    word = torch.where(valid, rows * w + (t >> 5), 0).reshape(-1)
    bit = torch.where(valid, torch.ones_like(t) << (t & 31), 0).reshape(-1)
    # distinct powers of two per word: their sum is their OR
    out = torch.zeros(b * w, dtype=torch.int64, device=t.device)
    out.index_add_(0, word, bit)
    return _as_int32(out).view(b, w)


def rows_to_indices(words: torch.Tensor, n_bits: int,
                    chunk_words: int = 1 << 20) -> list[np.ndarray]:
    """Each row's set bits below `n_bits` as a sorted int64 numpy array.

    The device-side counterpart of `np_to_indices` per row. Only non-zero
    words are expanded to bits; rows are taken in chunks of about
    `chunk_words` non-zero words so the intermediates stay bounded however
    dense a row is. One host transfer per chunk.
    """
    rows = words.shape[0]
    if rows == 0:
        return []
    nonzero_words = (words != 0).sum(1).tolist()
    bounds, acc = [0], 0
    for i, n in enumerate(nonzero_words):
        if acc and acc + n > chunk_words:
            bounds.append(i)
            acc = 0
        acc += n
    bounds.append(rows)
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    out: list[np.ndarray] = []
    for s, e in zip(bounds, bounds[1:]):
        blk = words[s:e]
        r, c = torch.nonzero(blk, as_tuple=True)       # row-major
        bits = ((blk[r, c][:, None] >> shifts) & 1).bool()
        m, b = torch.nonzero(bits, as_tuple=True)      # word-major, bit-ascending
        ids, row = c[m] * WORD + b, r[m]
        keep = ids < n_bits
        counts = torch.bincount(row[keep], minlength=e - s)
        ids = ids[keep].cpu().numpy()
        out.extend(np.split(ids, np.cumsum(counts.cpu().numpy())[:-1]))
    return out
