"""Plain PyTorch versions of the kernels.

The port's counterpart of `repro.kernels.ref`: the semantics of record.
A wrapper in `ops` takes these only for tensors on the CPU; on the card
`chip_smoke.py` holds each CUDA kernel against them. Each one works in
chunks of about `CHUNK_BYTES` of intermediate, so it also runs at the
production shapes on the card, where an unchunked unpack would not fit.

Words are int32 with the uint32 bit pattern (see `core.bitset`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import bitset

WORD = 32
CHUNK_BYTES = 1 << 28


def bit_matvec(a_bits: torch.Tensor, x: torch.Tensor,
               chunk_w: int = 256) -> torch.Tensor:
    """unpack(a_bits [C, W]) @ x [W*32, R] -> f32 [C, R].

    Summed in f64 over `chunk_w`-word slabs and rounded once to f32, as the
    CUDA kernel does: the result is the correctly rounded sum whatever the
    order, so the CPU and the card agree on every f-gain."""
    c, w = a_bits.shape
    out = torch.zeros((c, x.shape[1]), dtype=torch.float64, device=x.device)
    x64 = x.to(torch.float64)
    cw = max(1, min(chunk_w, w))
    rows = max(1, CHUNK_BYTES // (cw * WORD * 12))
    for r0 in range(0, c, rows):
        acc = out[r0:r0 + rows]
        for w0 in range(0, w, cw):
            acc += bitset.unpack(a_bits[r0:r0 + rows, w0:w0 + cw]).to(torch.float64) \
                @ x64[w0 * WORD:(w0 + cw) * WORD]
    return out.to(torch.float32)


def coverage_gain(a_bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """popcount(a_bits [C, W] & ~mask [W]) per row -> int32 [C]."""
    c, w = a_bits.shape
    out = torch.empty(c, dtype=torch.int32, device=a_bits.device)
    rows = max(1, CHUNK_BYTES // max(1, w * 8))
    for r0 in range(0, c, rows):
        out[r0:r0 + rows] = bitset.count_and_not(a_bits[r0:r0 + rows], mask)
    return out


def partition_gain(a_bits: torch.Tensor, mask: torch.Tensor,
                   bounds: tuple[int, ...]) -> torch.Tensor:
    """popcount(a_bits[:, lo_k:hi_k] & ~mask[lo_k:hi_k]) per row and
    partition -> int32 [C, P]; `bounds` are the P+1 word offsets. Integer
    sums, exact at any size (the reference's `_partition_gain_xla`)."""
    c, w = a_bits.shape
    p = len(bounds) - 1
    out = torch.empty((c, p), dtype=torch.int32, device=a_bits.device)
    rows = max(1, CHUNK_BYTES // max(1, w * 8))
    for r0 in range(0, c, rows):
        blk = a_bits[r0:r0 + rows]
        for k, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            out[r0:r0 + rows, k] = bitset.count_and_not(blk[:, lo:hi],
                                                        mask[lo:hi])
    return out


def sparse_gain(doc_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|{m : doc_ids[c, m] >= 0 and bit(mask, doc_ids[c, m]) == 0}| per row
    -> int32 [C]; `doc_ids` int32 [C, M] padded with -1 anywhere."""
    c, m = doc_ids.shape
    out = torch.empty(c, dtype=torch.int32, device=doc_ids.device)
    rows = max(1, CHUNK_BYTES // max(1, m * 24))
    for r0 in range(0, c, rows):
        ids = doc_ids[r0:r0 + rows]
        valid = ids >= 0
        idx = torch.where(valid, ids, 0)
        fresh = valid & ~bitset.bit_get(mask, idx)
        out[r0:r0 + rows] = fresh.sum(-1, dtype=torch.int32)
    return out


def clause_match(query_bits: torch.Tensor,
                 clause_bits: torch.Tensor) -> torch.Tensor:
    """eligible [B] bool = ∃k . clause_bits[k] ⊆ query_bits[b] (ψ^clause)."""
    b, wv = query_bits.shape
    k = clause_bits.shape[0]
    out = torch.zeros(b, dtype=torch.bool, device=query_bits.device)
    if k == 0 or b == 0:
        return out
    miss_q = ~query_bits
    ks = max(1, min(k, CHUNK_BYTES // max(1, wv * 4)))
    bs = max(1, CHUNK_BYTES // max(1, ks * wv * 4))
    for b0 in range(0, b, bs):
        q = miss_q[b0:b0 + bs, None, :]
        for k0 in range(0, k, ks):
            sub = ((clause_bits[None, k0:k0 + ks] & q) == 0).all(-1)
            out[b0:b0 + bs] |= sub.any(-1)
    return out


def clause_tokens(clause_bits: torch.Tensor,
                  slots: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """The compact clause table of `clause_match`'s first pass: each row's
    first `slots` set-bit positions, ascending, -1 past its count -> int32
    tokens [K, slots]; and its number of set bits, or slots + 1 for a row
    with more than `slots` (overflow) -> int32 count [K]."""
    k, wv = clause_bits.shape
    dev = clause_bits.device
    tokens = torch.full((k, slots), -1, dtype=torch.int32, device=dev)
    count = torch.empty(k, dtype=torch.int32, device=dev)
    shifts = torch.arange(WORD, dtype=torch.int32, device=dev)
    rows = max(1, CHUNK_BYTES // max(1, wv * WORD * 24))
    for r0 in range(0, k, rows):
        blk = clause_bits[r0:r0 + rows]
        r, w = torch.nonzero(blk, as_tuple=True)             # row-major
        bits = ((blk[r, w][:, None] >> shifts) & 1).bool()
        i, b = torch.nonzero(bits, as_tuple=True)            # bit-ascending
        row, pos = r[i], w[i] * WORD + b
        n = torch.bincount(row, minlength=blk.shape[0])
        rank = torch.arange(len(row), device=dev) - (torch.cumsum(n, 0) - n)[row]
        keep = rank < slots
        tokens[r0 + row[keep], rank[keep]] = pos[keep].to(torch.int32)
        count[r0:r0 + rows] = n.clamp(max=slots + 1).to(torch.int32)
    return tokens, count


def token_match(query_bits: torch.Tensor, clause_bits: torch.Tensor,
                tokens: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """eligible [B] bool from the compact table (`clause_tokens`), the
    arithmetic of `clause_match`'s second pass: a clause lies in a query iff
    each of its tokens is set there; an overflow clause (count > slots) is
    tested on its full row of `clause_bits`."""
    b = query_bits.shape[0]
    slots = tokens.shape[1]
    out = torch.zeros(b, dtype=torch.bool, device=query_bits.device)
    if b == 0 or tokens.shape[0] == 0:
        return out
    small = count <= slots
    tk = tokens[small]
    valid = tk >= 0
    safe = tk.clamp(min=0).long()
    word, shift = safe >> 5, (safe & 31).to(torch.int32)
    rows = max(1, CHUNK_BYTES // max(1, tk.numel() * 16))
    for b0 in range(0, b, rows):
        bit = (query_bits[b0:b0 + rows][:, word] >> shift) & 1     # [rows, k, slots]
        out[b0:b0 + rows] = ((bit == 1) | ~valid).all(-1).any(-1)
    if not bool(small.all()):
        out |= clause_match(query_bits, clause_bits[~small])
    return out


def tier_match(t1: torch.Tensor, t2: torch.Tensor, sel: torch.Tensor | None,
               tokens: torch.Tensor) -> torch.Tensor:
    """Per query, the AND of its tokens' postings rows, taken from `t1`
    where `sel` is set and from `t2` elsewhere (everywhere when `sel` is
    None). A -1 token is skipped; a query with none gets all-ones."""
    b, ell = tokens.shape
    w = t2.shape[1]
    out = torch.full((b, w), -1, dtype=torch.int32, device=t2.device)
    valid = tokens >= 0
    safe = torch.where(valid, tokens, 0).long()
    rows = max(1, CHUNK_BYTES // max(1, w * 4 * 3))
    for b0 in range(0, b, rows):
        acc = out[b0:b0 + rows]
        for j in range(ell):
            tok = safe[b0:b0 + rows, j]
            got = t2[tok]
            if sel is not None:
                got = torch.where(sel[b0:b0 + rows, None], t1[tok], got)
            acc &= torch.where(valid[b0:b0 + rows, j, None], got, -1)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """GQA attention with an optional sliding window and logit softcap, the
    reference's `ref.flash_attention`: q [B, Sq, Hq, D], k/v [B, Skv, Hkv,
    D] -> q's shape and dtype, f32 math. `q_offset` is the absolute
    position of q[:, 0]; only the first `kv_len` keys exist (the rest of a
    decode cache). Works through blocks of query positions so that the f32
    scores stay near `CHUNK_BYTES`."""
    if kv_len is not None:
        k, v = k[:, :kv_len], v[:, :kv_len]
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(skv, device=q.device)
    out = torch.empty_like(q)
    rows = max(1, CHUNK_BYTES // max(1, b * hq * skv * 4 * 3))
    for r0 in range(0, sq, rows):
        qc = q[:, r0:r0 + rows].float()
        n = qc.shape[1]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qc.reshape(b, n, hkv, g, d),
                              kf) / math.sqrt(d)
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        q_pos = torch.arange(r0, r0 + n, device=q.device) + q_offset
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        out[:, r0:r0 + n] = o.reshape(b, n, hq, d).to(q.dtype)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, softcap: float | None = None,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `flash_attention` (q_offset 0, every key valid) with
    respect to q, k and v, given its output `o` and the output's gradient
    `do`; the plain version of `csrc/flash_backward.cu`. q/o/do [B, S, Hq,
    D], k/v [B, Skv, Hkv, D] -> (dq, dk, dv) in f32, f32 math: scores
    masked to -1e30 as the reference's `chunked_attention` masks them, p
    their softmax, dp = do.v, ds = p * (dp - rowsum(do * o)), zero where a
    key is not visible, times 1 - (s / cap)^2 under a softcap; dk and dv
    summed over each KV head's G query heads. Works through blocks of query
    positions, dk and dv accumulated across them. `scale` (default
    1/sqrt(D)) multiplies the scores: a head dim zero-padded for the kernel
    keeps its true D's."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(skv, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    rows = max(1, CHUNK_BYTES // max(1, b * hq * skv * 4 * 6))
    for r0 in range(0, sq, rows):
        n = min(rows, sq - r0)
        qc = q[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)
        dc = do[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)
        delta = (dc * o[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)).sum(-1)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        q_pos = torch.arange(r0, r0 + n, device=q.device)
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        p = torch.softmax(torch.where(mask, s, torch.tensor(NEG, device=q.device)), dim=-1)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dc, vf)
        ds = torch.where(mask, p * (dp - delta.permute(0, 2, 3, 1)[..., None]),
                         torch.tensor(0.0, device=q.device))
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, dc)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc) * scale
        dq[:, r0:r0 + n] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
                            ).reshape(b, n, hq, d)
    return dq, dk, dv


def decode_keys(kv_len: int, q_offset: int, causal: bool = True,
                window: int | None = None) -> tuple[int, int]:
    """The keys [lo, hi) that one query at `q_offset` sees: every key inside
    is visible, every key outside masked (lo >= hi: none is visible)."""
    lo = max(0, q_offset - window + 1) if window is not None else 0
    hi = min(kv_len, q_offset + 1) if causal else kv_len
    return lo, hi


def split_keys(n_keys: int, n_splits: int) -> tuple[int, int]:
    """Cut `n_keys` keys into at most `n_splits` runs of `per` keys (the last
    one shorter), none empty -> (n_splits, per). No key: one empty run."""
    if n_keys <= 0:
        return 1, 0
    per = -(-n_keys // max(1, min(n_splits, n_keys)))
    return -(-n_keys // per), per


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 softcap: float | None = None, q_offset: int = 0,
                 kv_len: int | None = None, n_splits: int = 1) -> torch.Tensor:
    """`flash_attention` at Sq = 1, computed as the decode kernel computes
    it: q scaled by 1/sqrt(D) in f32, the visible keys `decode_keys` cut by
    `split_keys` into `n_splits` runs, each run's (m, l, acc) in f32, merged
    with weights exp(m_s - max m) and rounded once. With no visible key the
    runs cover [0, kv_len) with every score -1e30: the uniform mean of the
    first kv_len values, as the masked softmax gives."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if sq != 1:
        raise ValueError(f"flash_decode takes one query position, got Sq = {sq}")
    g = hq // hkv
    kv_len = skv if kv_len is None else kv_len
    lo, hi = decode_keys(kv_len, q_offset, causal, window)
    no_key = lo >= hi
    if no_key:
        lo, hi = 0, kv_len
    n, per = split_keys(hi - lo, n_splits)
    if per == 0:
        return torch.zeros_like(q)
    qf = q[:, 0].float().reshape(b, hkv, g, d) * (1.0 / math.sqrt(d))
    ms, ls, accs = [], [], []
    for s in range(n):
        a, e = lo + s * per, min(hi, lo + (s + 1) * per)
        logits = torch.einsum("bhgd,bkhd->bhgk", qf, k[:, a:e].float())
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        if no_key:
            logits = torch.full_like(logits, -1e30)
        m = logits.max(-1).values
        p = torch.exp(logits - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, v[:, a:e].float()))
    m_star = torch.stack(ms).max(0).values
    w = [torch.exp(m - m_star) for m in ms]
    num = sum(wi[..., None] * acc for wi, acc in zip(w, accs))
    den = sum(wi * li for wi, li in zip(w, ls)).clamp(min=1e-30)
    return (num / den[..., None]).reshape(b, 1, hq, d).to(q.dtype)


LOG2E = 1.4426950408889634
NEG = -1e30
PREFILL_KEYS = 64      # keys per KV tile of the prefill kernel


def tanh_accurate(y: torch.Tensor) -> torch.Tensor:
    """tanh as the prefill kernel computes it: 1 - 2 / (1 + 2^(2|y| log2 e))
    with the sign of y, within ~1e-7 of tanh (tanh.approx's 2^-11 relative
    error, through a softcap of 50, is too coarse for the attention's
    limit)."""
    e = torch.exp2(y.abs() * (2.0 * LOG2E))
    return torch.copysign(1.0 - 2.0 / (1.0 + e), y)


def split_bf16(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """p = hi + lo to about 2^-16 relative, both bf16: hi = bf16(p),
    lo = bf16(p - hi). P·V as hi·V + lo·V keeps p's f32 accuracy on bf16
    tensor cores, where one bf16 P misses the attention's limit."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def prefill_keys(p_lo: int, p_hi: int, kv_len: int, causal: bool,
                 window: int | None, tile: int = PREFILL_KEYS) -> tuple[int, int]:
    """The keys [begin, end) that a block of query positions p_lo..p_hi
    walks (the block skip), begin cut down to a `tile` edge: the union of its
    rows' visible keys, or all of [0, kv_len) when its last row sees none
    (the rows that see no key are the latest ones)."""
    begin = max(0, p_lo - window + 1) if window is not None else 0
    end = min(kv_len, p_hi + 1) if causal else kv_len
    lo, hi = decode_keys(kv_len, p_hi, causal, window)
    if lo >= hi:
        begin, end = 0, kv_len
    return begin // tile * tile, end


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, q_offset: int = 0,
                  kv_len: int | None = None,
                  lse_out: torch.Tensor | None = None) -> torch.Tensor:
    """`flash_attention` computed as the bf16 prefill kernel computes it:
    per block of query positions, the keys `prefill_keys` gives in tiles of
    PREFILL_KEYS by online softmax; scores q·k in f32, times 1/sqrt(D) after
    the product, `tanh_accurate` softcap, masked to NEG = -1e30, in base 2
    (log2 e folded in); P·V as hi·V + lo·V (`split_bf16`); one division by
    max(l, 1e-30) and one rounding to q's dtype. A row that sees no key
    scores NEG on every valid key: the uniform mean of v[:kv_len]. Keys at
    or past kv_len, which the kernel reads as zeros with p = 0, are left out.
    `lse_out` [B, Hq, Sq] f32, when given, receives each row's log-sum-exp
    in base 2 from the same m and l: lse2 = m + log2(l)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    g = hq // hkv
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=torch.float32)
    out = torch.empty_like(q)
    n = max(1, CHUNK_BYTES // max(1, b * hq * (d + 3 * PREFILL_KEYS) * 4 * 4))
    for p0 in range(0, sq, n):
        qc = q[:, p0:p0 + n].float().reshape(b, -1, hkv, g, d)
        nn = qc.shape[1]
        pos = torch.arange(p0, p0 + nn, device=q.device) + q_offset
        begin, end = prefill_keys(p0 + q_offset, p0 + nn - 1 + q_offset,
                                  kv_len, causal, window)
        m = torch.full((b, hkv, g, nn), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, nn, d), device=q.device)
        for k0 in range(begin, end, PREFILL_KEYS):
            k1 = min(k0 + PREFILL_KEYS, kv_len)
            vt = v[:, k0:k1].float()
            s = torch.einsum("bnhgd,bthd->bhgnt", qc, k[:, k0:k1].float()) * scale
            if softcap is not None:
                s = softcap * tanh_accurate(s * inv_cap)
            s = s * LOG2E
            kp = torch.arange(k0, k1, device=q.device)
            mask = torch.ones((nn, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= pos[:, None] >= kp[None, :]
            if window is not None:
                mask &= pos[:, None] - kp[None, :] < window
            s = torch.where(mask, s, torch.tensor(NEG, device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            hi, lo = split_bf16(p)
            acc = acc * corr[..., None] \
                + torch.einsum("bhgnt,bthd->bhgnd", hi.float(), vt) \
                + torch.einsum("bhgnt,bthd->bhgnd", lo.float(), vt)
            m = m_new
        o = acc / l.clamp(min=1e-30)[..., None]
        out[:, p0:p0 + nn] = o.permute(0, 3, 1, 2, 4).reshape(b, nn, hq, d).to(q.dtype)
        if lse_out is not None:
            lse_out[:, :, p0:p0 + nn] = (m + torch.log2(l)).reshape(b, hq, nn)
    return out


def flash_backward_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `flash_attention` (q_offset 0, every key valid) as
    `csrc/flash_backward_tc.cu` computes it, from the forward's output `o`,
    its gradient `do` and each row's log-sum-exp `lse` [B, Hq, S] in base 2
    (`flash_prefill`'s `lse_out`): scores q·k in f32 times 1/sqrt(D) after
    the product, `tanh_accurate` softcap t, p = 2^(s log2 e - lse) where
    visible (0 elsewhere), dp = do·v, delta = rowsum(do * o) in f32,
    ds = p * (1 - t^2) * (dp - delta) (without a softcap p * (dp -
    delta)); then P and dS
    rounded to bf16 where the kernel feeds them to the tensor cores:
    dv = sum bf16(p)·do, dk = (sum bf16(ds)·q) / sqrt(D), dq = (sum
    bf16(ds)·k) / sqrt(D), f32 sums, dk and dv over each KV head's G query
    heads. -> (dq, dk, dv) in f32. Works through blocks of query
    positions, dk and dv accumulated across them."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=torch.float32)
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(skv, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    rows = max(1, CHUNK_BYTES // max(1, b * hq * skv * 4 * 6))
    for r0 in range(0, sq, rows):
        n = min(rows, sq - r0)
        qc = q[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)
        dc = do[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)
        delta = (dc * o[:, r0:r0 + n].float().reshape(b, n, hkv, g, d)).sum(-1)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        if softcap is not None:
            t = tanh_accurate(s * inv_cap)
            s = softcap * t
        q_pos = torch.arange(r0, r0 + n, device=q.device)
        mask = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        lse_c = lse[:, :, r0:r0 + n].float().reshape(b, hkv, g, n, 1)
        p = torch.where(mask, torch.exp2(s * LOG2E - lse_c),
                        torch.tensor(0.0, device=q.device))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dc, vf)
        pdc = p * (1.0 - t * t) if softcap is not None else p
        ds = pdc * (dp - delta.permute(0, 2, 3, 1)[..., None])
        pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        dv += torch.einsum("bhgqk,bqhgd->bkhd", pb, dc)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", dsb, qc)
        dq[:, r0:r0 + n] = (torch.einsum("bhgqk,bkhd->bqhgd", dsb, kf) * scale
                            ).reshape(b, n, hq, d)
    return dq, dk * scale, dv


TILE_ROWS = 64         # (position, group head) rows per CTA of the tile kernel
TILE_KEYS = 32         # keys per K/V tile of the tile kernel


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, 10 explicit mantissa bits (the low 13 bits zeroed), on the
    int32 view; subnormals round in place, a value past the largest TF32
    becomes Inf, Inf and NaN pass through."""
    i = x.contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo to about 2^-22 relative, both TF32 values held in f32:
    hi = tf32(x), lo = tf32(x - hi). A product as hi·hi + hi·lo + lo·hi on
    TF32 tensor cores keeps f32's accuracy (one TF32 pass rounds each
    operand to 2^-11); a bf16 value is exact in TF32, so its lo is 0."""
    x = x.float()
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def split_tf32_raw(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo as `csrc/flash_backward_short.cu` splits it, in three
    instructions: hi = tf32(x) (`split_tf32`'s), lo = x - hi passed as it
    is, of which the tensor core reads the TF32 bits (lo truncated toward
    zero). hi·hi + hi·lo + lo·hi is within about 2^-21 of the f32
    product."""
    x = x.float()
    hi = _tf32(x)
    lo = ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _split_product(eq: str, a: tuple[torch.Tensor, torch.Tensor],
                   b: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """a·b as the tile kernel's three TF32 products, summed in f32."""
    return (torch.einsum(eq, a[0], b[0]) + torch.einsum(eq, a[0], b[1])
            + torch.einsum(eq, a[1], b[0]))


def flash_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int | None = None,
               softcap: float | None = None, q_offset: int = 0,
               kv_len: int | None = None, scale: float | None = None) -> torch.Tensor:
    """`flash_attention` computed as the tile kernel computes it: the rows of
    a KV head are its flattened (query position, group head) pairs, r =
    position * G + head, in blocks of TILE_ROWS; each block walks the keys
    `prefill_keys` gives its first and last positions, in tiles of
    TILE_KEYS, by online softmax in base 2. Q·K^T and P·V are each three
    TF32 products of split operands (`split_tf32`: hi·hi + hi·lo + lo·hi,
    summed in f32); the scores are times 1/sqrt(D) after the product, take
    the `tanh_accurate` softcap and the mask NEG = -1e30; one division by
    max(l, 1e-30) and one rounding to q's dtype. Keys at or past kv_len,
    which the kernel reads as zeros with p = 0, are left out; a row that
    sees no key gives the uniform mean of v[:kv_len]. `scale` replaces
    1/sqrt(D) where the wrapper zero-pads a head dim below 8."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    g = hq // hkv
    n_rows = sq * g
    scale = torch.tensor(1.0 / math.sqrt(d) if scale is None else scale,
                         dtype=torch.float32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=torch.float32)
    rows = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, n_rows, d)
    qs = split_tf32(rows)
    out = torch.empty_like(rows)
    for r0 in range(0, n_rows, TILE_ROWS):
        r1 = min(r0 + TILE_ROWS, n_rows)
        pos = torch.arange(r0, r1, device=q.device) // g + q_offset
        begin, end = prefill_keys(r0 // g + q_offset, (r1 - 1) // g + q_offset,
                                  kv_len, causal, window, TILE_KEYS)
        qb = tuple(x[:, :, r0:r1] for x in qs)
        m = torch.full((b, hkv, r1 - r0), NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, r1 - r0, d), device=q.device)
        for k0 in range(begin, end, TILE_KEYS):
            k1 = min(k0 + TILE_KEYS, kv_len)
            s = _split_product("bhnd,bthd->bhnt", qb, split_tf32(k[:, k0:k1])) * scale
            if softcap is not None:
                s = softcap * tanh_accurate(s * inv_cap)
            s = s * LOG2E
            kp = torch.arange(k0, k1, device=q.device)
            mask = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= pos[:, None] >= kp[None, :]
            if window is not None:
                mask &= pos[:, None] - kp[None, :] < window
            s = torch.where(mask, s, torch.tensor(NEG, device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _split_product(
                "bhnt,bthd->bhnd", split_tf32(p), split_tf32(v[:, k0:k1]))
            m = m_new
        out[:, :, r0:r1] = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, sq, hq, d).to(q.dtype)


def flash_backward_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                         window: int | None = None, softcap: float | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `flash_attention` (q_offset 0, every key valid) as
    `csrc/flash_backward_short.cu` computes it, from the forward's output
    `o` and its gradient `do`: per (batch, kv head) unit, rows r = position
    * G + head against all Skv keys; s = Q·K^T times 1/sqrt(D) after the
    product, under a softcap cap * tanh(s / cap); each row's max m over its
    visible keys, lse = m + log(sum exp(s - m)) (+inf for a row that sees
    none), p = exp(s - lse) where visible and 0 elsewhere, dp = dO·V^T,
    delta = rowsum(dO * o), ds = p * (dp - delta) times 1 - (s / cap)^2
    under a softcap; dq = dS·K / sqrt(D), dk = dS^T·Q / sqrt(D), dv =
    P^T·dO. Every product is three TF32 products of operands split as the
    kernel's tensor-core route splits them (`split_tf32_raw`,
    `_split_product`), summed in f32. -> (dq, dk, dv) in f32. Works
    through blocks of batch entries. (The kernel's CUDA-core route, D <= 8
    and Skv <= 32, multiplies in f32: its plain version is
    `flash_attention_bwd`.)"""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    inv_cap = None if softcap is None else torch.tensor(1.0 / softcap,
                                                        dtype=torch.float32)
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask = mask.repeat_interleave(g, dim=0)                   # [S * G, Skv]
    zero = torch.tensor(0.0, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    per = max(1, CHUNK_BYTES // max(1, hkv * sq * g * skv * 4 * 6))
    for b0 in range(0, b, per):
        n = min(per, b - b0)

        def rows(x):
            return x[b0:b0 + n].float().reshape(n, sq, hkv, g, d).permute(0, 2, 1, 3, 4) \
                .reshape(n, hkv, sq * g, d)
        qr, dor, orr = rows(q), rows(do), rows(o)
        kb, vb = (x[b0:b0 + n].float().permute(0, 2, 1, 3) for x in (k, v))
        ks = split_tf32_raw(kb)
        s = _split_product("bhrd,bhkd->bhrk", split_tf32_raw(qr), ks) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s * inv_cap)
        m = torch.where(mask, s, -torch.inf).amax(-1, keepdim=True)
        l = torch.where(mask, torch.exp(s - m), zero).sum(-1, keepdim=True)
        lse = torch.where(l > 0, m + torch.log(l), torch.inf)
        p = torch.where(mask, torch.exp(s - lse), zero)
        dp = _split_product("bhrd,bhkd->bhrk", split_tf32_raw(dor), split_tf32_raw(vb))
        ds = p * (dp - (dor * orr).sum(-1, keepdim=True))
        if softcap is not None:
            t = s * inv_cap
            ds = ds * (1.0 - t * t)
        ds = torch.where(mask, ds, zero)
        dss = split_tf32_raw(ds)
        gq = _split_product("bhrk,bhkd->bhrd", dss, ks) * scale
        dq[b0:b0 + n] = gq.reshape(n, hkv, sq, g, d).permute(0, 2, 1, 3, 4) \
            .reshape(n, sq, hq, d)
        dk[b0:b0 + n] = (_split_product("bhrk,bhrd->bhkd", dss, split_tf32_raw(qr))
                         * scale).permute(0, 2, 1, 3)
        dv[b0:b0 + n] = _split_product("bhrk,bhrd->bhkd", split_tf32_raw(p),
                                       split_tf32_raw(dor)).permute(0, 2, 1, 3)
    return dq, dk, dv


def flash_attention_short(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          softcap: float | None = None, q_offset: int = 0,
                          kv_len: int | None = None) -> torch.Tensor:
    """`flash_attention` as the tensor-core route of
    `csrc/flash_attention_short.cu` computes it: per (batch, kv head) unit,
    rows r = position * G + head against the first kv_len keys at once, in
    base 2: q times 1/sqrt(D) * log2(e) before the product (times 1/sqrt(D)
    alone under a softcap, whose cap * tanh(s / cap) is then times log2(e));
    each row's max m over its visible keys, p = 2^(s - m) where visible and
    0 elsewhere (a row that sees no key: p = 1 on every key below kv_len,
    the uniform mean), l = sum p, o = P·V / l (0 at kv_len 0). Q·K^T and P·V
    are each three TF32 products of operands split as the kernel splits
    them (`split_tf32_raw`, `_split_product`), summed in f32; one rounding
    to q's dtype. (The kernel takes its max from hi·hi products alone: a
    shift of each row's scores, which the softmax cancels.) Works through
    blocks of batch entries. (The kernel's CUDA-core route, D <= 8 and Skv
    <= 32, multiplies in f32: its plain version is `flash_attention`.)"""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kv_len = skv if kv_len is None else int(kv_len)
    g = hq // hkv
    out = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    if kv_len == 0 or out.numel() == 0:
        return out
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    qs = scale if softcap is not None else scale * log2e
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(kv_len, device=q.device)
    mask = torch.ones((sq, kv_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    mask = mask.repeat_interleave(g, dim=0)                   # [Sq * G, kv_len]
    none = ~mask.any(-1, keepdim=True)
    zero, one = torch.tensor(0.0, device=q.device), torch.tensor(1.0, device=q.device)
    per = max(1, CHUNK_BYTES // max(1, hkv * sq * g * kv_len * 4 * 4))
    for b0 in range(0, b, per):
        n = min(per, b - b0)
        qr = q[b0:b0 + n].float().reshape(n, sq, hkv, g, d).permute(0, 2, 1, 3, 4) \
            .reshape(n, hkv, sq * g, d) * qs
        kb, vb = (x[b0:b0 + n, :kv_len].float().permute(0, 2, 1, 3) for x in (k, v))
        s = _split_product("bhrd,bhkd->bhrk", split_tf32_raw(qr), split_tf32_raw(kb))
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap) * log2e
        m = torch.where(mask, s, -torch.inf).amax(-1, keepdim=True)
        p = torch.where(none, one, torch.where(mask, torch.exp2(s - m), zero))
        o = _split_product("bhrk,bhkd->bhrd", split_tf32_raw(p), split_tf32_raw(vb)) \
            / p.sum(-1, keepdim=True)
        out[b0:b0 + n] = o.reshape(n, hkv, sq, g, d).permute(0, 2, 1, 3, 4) \
            .reshape(n, sq, hq, d).to(q.dtype)
    return out


def segment_sum(rows: torch.Tensor, perm: torch.Tensor | None, offsets: torch.Tensor,
                out0: torch.Tensor | None = None, bounds: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """out[n] = out0[n] + rows[perm[offsets[n]]] + ... + rows[perm[offsets[n+1] - 1]]
    as [N, F] (out0 None: zeros), each segment's rows added one at a time,
    left to right, in `rows`' dtype: the arithmetic of `csrc/segment_sum.cu`.
    With perm None the rows lie in segment order (segment n is rows
    offsets[n] .. offsets[n+1] - 1). With `bounds` ([n_lo, n_hi)) only those
    segments are summed and written: into `out` when given (in place; it may
    be out0), else into a copy of out0 (or zeros). Without `bounds` every
    segment is, into `out` or a new tensor.

    Step k adds every segment's k-th row (the segments longest first, so the
    ones still adding are a prefix), so the order within a segment is the
    plan's on either device and the card's kernel equals this bit for bit;
    on the CPU it also equals `index_add_` over rows[perm] in that order."""
    n, f = offsets.shape[0] - 1, rows.shape[1]
    lo, hi = (0, n) if bounds is None else (int(bounds[0]), int(bounds[1]))
    hi = max(lo, hi)
    acc = (torch.zeros((hi - lo, f), dtype=rows.dtype, device=rows.device) if out0 is None
           else out0[lo:hi].clone())
    if out is None:
        out = acc if bounds is None else (
            torch.zeros((n, f), dtype=rows.dtype, device=rows.device) if out0 is None
            else out0.clone())
    off = offsets[lo:hi + 1].long()
    if hi > lo and (perm is None or perm.shape[0]):
        counts = off[1:] - off[:-1]
        order = torch.sort(counts, descending=True, stable=True).indices
        starts, longest = off[:-1][order], int(counts.max())
        # live[k]: the segments with more than k rows, a prefix of `order`
        live = (hi - lo - torch.cumsum(torch.bincount(counts, minlength=longest + 1),
                                       0)).tolist()
        idx = None if perm is None else perm.long()
        for k in range(longest):
            at = starts[:live[k]] + k
            acc[order[:live[k]]] += rows[at if idx is None else idx[at]]
    if out is not acc:
        out[lo:hi] = acc
    return out
    off = offsets.long()
    counts = off[1:] - off[:-1]
    order = torch.sort(counts, descending=True, stable=True).indices
    starts, longest = off[:-1][order], int(counts.max())
    # live[k]: the segments with more than k rows, a prefix of `order`
    live = (n - torch.cumsum(torch.bincount(counts, minlength=longest + 1), 0)).tolist()
    idx = perm.long()
    for k in range(longest):
        seg = order[:live[k]]
        out[seg] += rows[idx[starts[:live[k]] + k]]
    return out
