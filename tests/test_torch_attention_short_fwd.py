"""The short-sequence attention forward (`csrc/flash_attention_short.cu`):
its routing rule and plans on meta tensors, and its arithmetic on the CPU.

`flash_attention.route` sends a forward of Sq > 1, or of any Sq at a head
dim below 8, with Skv up to SHORT_MAX_S and D up to SHORT_MAX_D (f32 or
bf16) to the kernel, and everything else where it went before; every plan
fits a block's shared memory and, on the tensor-core route, puts the
fragment loads on distinct banks. The tensor-core route's plain version
`ref.flash_attention_short` (per-unit full-row softmax, Q·K^T and P·V each
three TF32 products of split operands) agrees with the reference's
`chunked_attention`, its oracle `repro.kernels.ref.flash_attention` and its
Pallas kernel in interpret mode at LIMIT x each row's rms (`chip_smoke.py`'s
`row_error`; in bf16 plus 2^-8 |want|), on seeded numpy inputs at BST's and
BERT4Rec's head shapes and with a causal mask, a window, a softcap, a query
offset, kv_len < Skv and rows that see no key; one TF32 pass would not. The
CUDA-core route's plain version is `ref.flash_attention`. On the CPU the
forward stays `ref.flash_attention` and the gradient `ref.flash_attention_bwd`.
The kernel runs only on the card (`chip_smoke.py` phases 4 and 7a)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import common as jcommon
from repro_torch.kernels import _build, flash_attention, flash_backward, ops, ref

LIMIT = 2e-4             # chip_smoke's forward limit: 2e-4 x each row's rms
BF16_ROUND = 2.0 ** -8   # plus, in bf16, the output's rounding
SMEM_PER_BLOCK = 232448
SHORT = "flash_attention_short"

# b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len: BST's head
# (S 21, H 8, D 4) and BERT4Rec's (S 200, H 2, D 32) at a small batch, a
# D below 8 that is not 4, G 2 and 4, causal with a window and a softcap, a
# query offset with kv_len < Skv, Sq != Skv, the tiny route's most keys
CASES = [
    (3, 21, 21, 8, 8, 4, False, None, None, 0, None),
    (1, 200, 200, 2, 2, 32, False, None, None, 0, None),
    (2, 9, 9, 4, 2, 3, True, None, None, 0, None),
    (2, 33, 33, 4, 2, 16, False, None, None, 0, None),
    (1, 40, 40, 8, 2, 32, True, 9, 30.0, 0, None),
    (2, 21, 21, 8, 4, 4, True, 5, 20.0, 0, None),
    (1, 20, 36, 4, 1, 8, True, None, None, 16, 30),
    (1, 64, 130, 2, 2, 16, True, 40, 50.0, 60, 120),
    (2, 5, 32, 6, 2, 6, True, 8, None, 27, 31),
    (1, 256, 256, 2, 1, 32, True, None, None, 0, None),
]
# rows that see no key: the window starts past the last valid key (all
# rows, some rows), on both routes; kv_len 0
NO_KEY_CASES = [
    (1, 8, 30, 4, 2, 8, True, 6, None, 60, 30),
    (1, 24, 100, 4, 2, 32, True, 8, None, 80, 90),
    (2, 12, 20, 4, 4, 4, True, 3, 30.0, 14, 17),
    (1, 10, 10, 2, 1, 16, True, None, None, 0, 0),
    (1, 6, 6, 4, 2, 4, True, None, None, 0, 0),
]


def _ids(c):
    return "b{}sq{}skv{}hq{}hkv{}d{}c{}w{}cap{}qo{}kv{}".format(*c)


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _ratio(got, want, bf16: bool = False) -> float:
    """The largest |got - want| over its limit: LIMIT x the rms of want's
    row (batch entry and query position), plus 2^-8 |want| in bf16."""
    got = torch.as_tensor(np.array(got, np.float32))
    want = torch.as_tensor(np.array(want, np.float32))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    lim = LIMIT * rms + (BF16_ROUND * want.abs() if bf16 else 0.0)
    return float(((got - want).abs() / lim.clamp(min=1e-30)).max())


def _meta(b, s, h, d, dtype=torch.float32):
    return torch.empty((b, s, h, d), dtype=dtype, device="meta")


def _references(q, k, v, causal, window, cap, q_offset, kv_len):
    """The reference's oracle and its Pallas kernel in interpret mode on the
    first kv_len keys, and `chunked_attention` with kv_len (its one chunk
    holds every key)."""
    n = k.shape[1] if kv_len is None else kv_len
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k[:, :n], v[:, :n]))
    out = [jref.flash_attention(jq, jk, jv, **kw),
           pallas_flash(jq, jk, jv, block_q=8, block_k=8, interpret=True, **kw)]
    out.append(jcommon.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal, window=window, cap=cap,
                                         q_offset=q_offset, kv_len=kv_len,
                                         chunk=k.shape[1]))
    return [np.asarray(x, np.float32) for x in out]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [1, 3, 4, 7, 8, 12, 16, 32])
@pytest.mark.parametrize("s", [2, 21, 32, 33, 200, flash_attention.SHORT_MAX_S])
def test_short_sequences_route_to_the_short_kernel(s, d, dtype):
    """Sq > 1 up to SHORT_MAX_S keys at D <= 32, G 1-4, f32 or bf16: the
    short kernel, whose plan fits a block; a single query row too where D
    is below 8 (and not at D >= 8: flash_decode keeps it)."""
    for hq, hkv in ((8, 8), (4, 2), (6, 2), (8, 2)):
        q, k = _meta(3, s, hq, d, dtype), _meta(3, s, hkv, d, dtype)
        assert flash_attention.route(q, k, k) == SHORT
        plan = flash_attention.short_plan(s, s, d, hq, hkv, dtype)
        assert plan is not None and plan.smem <= SMEM_PER_BLOCK
        one = _meta(3, 1, hq, d, dtype)
        assert flash_attention.route(one, k, k) == (SHORT if d < 8 else "flash_decode")


def test_other_calls_keep_their_routes():
    """Past SHORT_MAX_S keys (D 4 still padded on the tile kernel, D 32 on
    the tile kernel, a decode row at D 8 on flash_decode), D 64 and above,
    bf16 prefill shapes on flash_prefill, f16 nowhere new."""
    past = flash_attention.SHORT_MAX_S + 1
    for s, d, want in ((past, 4, "flash_attention"), (past, 32, "flash_attention"),
                       (21, 64, "flash_attention"), (200, 128, "flash_attention")):
        q, k = _meta(2, s, 4, d), _meta(2, s, 2, d)
        assert flash_attention.route(q, k, k) == want, (s, d)
    one, cache = _meta(2, 1, 4, 4), _meta(2, past, 2, 4)
    assert flash_attention.route(one, cache, cache) == "flash_attention"
    one, cache = _meta(2, 1, 4, 8), _meta(2, 40, 2, 8)
    assert flash_attention.route(one, cache, cache) == "flash_decode"
    qb, kb = _meta(1, 64, 8, 64, torch.bfloat16), _meta(1, 64, 2, 64, torch.bfloat16)
    assert flash_attention.route(qb, kb, kb) == "flash_prefill"
    assert flash_attention.short_plan(21, 21, 4, 8, 8, torch.float16) is None
    assert flash_attention.short_plan(21, past, 4, 8, 8, torch.float32) is None
    assert flash_attention.short_plan(21, 21, 33, 8, 8, torch.float32) is None
    # no short call writes an lse: the tensor-core backward's forwards are D 64+
    assert not any(flash_backward.takes(_meta(1, 64, 8, d, torch.bfloat16),
                                        _meta(1, 64, 2, d, torch.bfloat16),
                                        _meta(1, 64, 2, d, torch.bfloat16))
                   for d in range(1, flash_attention.SHORT_MAX_D + 1))


def _phase_banks(addrs: list[int], width: int) -> bool:
    """Do 32 lanes loading `width` consecutive words at `addrs` hit distinct
    banks within each phase (a phase is 128 bytes of the warp's request)?"""
    per = 32 // width
    for p0 in range(0, 32, per):
        banks = [(a + w) % 32 for a in addrs[p0:p0 + per] for w in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("d", [1, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("sq,skv", [(1, 21), (2, 2), (21, 21), (32, 32), (33, 33),
                                    (64, 64), (65, 65), (200, 200), (256, 256),
                                    (1000, 20), (7, 130)])
def test_short_plan_fits_and_loads_without_bank_conflicts(sq, skv, d, g):
    """Every plan fits a block's shared memory as the kernel's own formulas
    count it (K and V of its units), its units are a multiple or a divisor
    of Hkv (whole batch entries, or part of one), and its threads a
    multiple of 32. The CUDA-core route (D <= 8, Skv <= 32): K and V rows
    of 4 or 8 words, up to TINY_MAX_ROWS rows a thread with the fewest idle
    row slots, at most TINY_MAX_THREADS threads, at most TINY_SMEM bytes
    unless a unit needs more. The tensor-core route: FWD_WARPS warps, K as
    rows of hi then lo at a stride of 8 mod 32 words (float2 loads at row
    gr, column 2t, of either) and V at 4 mod 32 (one word at rows 2t and
    2t + 1, column gr): distinct banks."""
    for hkv in (1, 2, 8):
        hq = g * hkv
        plan = flash_attention.short_plan(sq, skv, d, hq, hkv, torch.float32)
        assert plan is not None and plan.smem <= SMEM_PER_BLOCK
        assert plan.units % hkv == 0 or hkv % plan.units == 0
        assert plan.threads % 32 == 0 and plan.threads >= 32
        if plan.tiny:
            assert d <= flash_attention.TINY_MAX_D and skv <= flash_attention.TINY_MAX_S
            assert plan.dp == (4 if d <= 4 else 8)
            assert plan.smem == 8 * plan.units * skv * plan.dp
            r = plan.rows
            most = flash_attention.TINY_MAX_ROWS[plan.dp]
            assert 1 <= r <= most
            p0 = -(-sq // r)
            best = min(-(-sq // x) * x for x in range(1, most + 1))
            assert p0 * r == best
            assert plan.threads == min(flash_attention.TINY_MAX_THREADS,
                                       -(-plan.units * p0 * g // 32) * 32)
            assert plan.smem <= flash_attention.TINY_SMEM or plan.units == 1
            continue
        assert not (d <= flash_attention.TINY_MAX_D and skv <= flash_attention.TINY_MAX_S)
        assert plan.dp >= d and plan.dp in (8, 16, 32)
        assert plan.threads == 32 * flash_attention.FWD_WARPS
        sk, sv = flash_attention._words(2 * plan.dp, 8), flash_attention._words(plan.dp, 4)
        assert plan.smem == 4 * plan.units * (-(-skv // 8) * 8) * (sk + sv)
        assert plan.smem <= flash_attention.FWD_SMEM or plan.units == 1
        lanes = [(lane // 4, lane % 4) for lane in range(32)]
        for half in (0, plan.dp):   # hi, then lo
            assert _phase_banks([gr * sk + half + 2 * t for gr, t in lanes], 2)
        assert _phase_banks([2 * t * sv + gr for gr, t in lanes], 1)
        assert _phase_banks([(2 * t + 1) * sv + gr for gr, t in lanes], 1)


def test_plans_at_the_recsys_shapes():
    """BST's call: the CUDA-core route, 3 rows a thread (positions 7 apart),
    4 batch entries (32 units, 672 rows) a CTA of 224 threads, none idle;
    BERT4Rec's: the tensor-core route, one unit (13 row tiles) a CTA of 8
    warps, 86400 bytes (two CTAs an SM)."""
    bst = flash_attention.short_plan(21, 21, 4, 8, 8, torch.float32)
    assert bst == flash_attention.ShortPlan(True, 4, 3, 32, 224, 21504)
    b4r = flash_attention.short_plan(200, 200, 32, 2, 2, torch.float32)
    assert b4r == flash_attention.ShortPlan(False, 32, 16, 1, 256, 86400)
    assert 2 * b4r.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_version_matches_the_reference(case):
    """`ref.flash_attention_short` (and the CUDA-core route's plain version
    `ref.flash_attention`) against chunked_attention, the reference's oracle
    and its Pallas kernel in interpret mode, each row within LIMIT x its
    rms; NaN keys and values past kv_len change nothing."""
    b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len = case
    q, k, v = _qkv(sum(case[:6]), b, sq, skv, hq, hkv, d)
    if kv_len is not None:
        k[:, kv_len:] = np.nan
        v[:, kv_len:] = np.nan
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.flash_attention_short(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and got.shape == (b, sq, hq, d)
    wants = _references(q, np.nan_to_num(k), np.nan_to_num(v), causal, window, cap,
                        q_offset, kv_len)
    for want in wants + [ref.flash_attention(tq, tk, tv, **kw).numpy()]:
        assert _ratio(got, want) <= 1.0
    plain = ref.flash_attention(tq, tk, tv, **kw)
    for want in wants:
        assert _ratio(plain, want) <= 1.0


@pytest.mark.parametrize("case", [c for c in CASES if c[5] >= 8], ids=_ids)
def test_plain_version_in_bf16(case):
    """bf16 operands are read as f32 and the output rounded once: within
    LIMIT x the row's rms plus 2^-8 |want| of the f32 reference on the same
    (bf16) values."""
    b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len = case
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(sum(case[:6]) + 1, b, sq, skv, hq, hkv, d))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    got = ref.flash_attention_short(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert _ratio(got.float(), want, bf16=True) <= 1.0


@pytest.mark.parametrize("case", NO_KEY_CASES, ids=_ids)
def test_rows_with_no_visible_key(case):
    """Such a row gives the uniform mean of v[:kv_len] (0 at kv_len 0) on
    both plain versions, as the reference's oracle does (its Pallas kernel
    skips such rows' blocks and gives 0: the port keeps the oracle's rule);
    the other rows are unchanged."""
    b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len = case
    q, k, v = _qkv(sq + skv + d, b, sq, skv, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    pos = np.arange(sq) + q_offset
    none = pos - window + 1 >= kv_len if window else np.full(sq, kv_len == 0)
    assert none.any()
    mean = tv[:, :kv_len].mean(1) if kv_len else torch.zeros((b, hkv, d))
    uniform = mean.repeat_interleave(hq // hkv, dim=1)
    for got in (ref.flash_attention_short(tq, tk, tv, **kw),
                ref.flash_attention(tq, tk, tv, **kw)):
        for i in np.nonzero(none)[0]:
            torch.testing.assert_close(got[:, i], uniform, rtol=1e-6, atol=1e-6)
        if kv_len:
            want = _references(q, k, v, causal, window, cap, q_offset, kv_len)[0]
            assert _ratio(got, want) <= 1.0
        else:
            assert not got.abs().any()


def test_one_tf32_pass_breaks_the_limit(monkeypatch):
    """Each operand rounded once to TF32 (lo dropped) puts BERT4Rec's
    forward past the row limit: why the kernel splits every operand."""
    b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len = CASES[1]
    q, k, v = _qkv(11, b, sq, skv, hq, hkv, d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = ref.flash_attention(tq.double(), tk.double(), tv.double(), causal=False).float()
    assert _ratio(ref.flash_attention_short(tq, tk, tv, causal=False), want) <= 1.0
    split = ref.split_tf32_raw
    monkeypatch.setattr(ref, "split_tf32_raw", lambda x: (
        split(x)[0], torch.zeros_like(x, dtype=torch.float32)))
    assert _ratio(ref.flash_attention_short(tq, tk, tv, causal=False), want) > 1.0


def test_grouped_rows_equal_repeated_heads():
    """The flattened (position, group head) rows give each query head its
    own output: G 4 equals the same call with K and V repeated to every
    head."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 19, 19, 8, 2, 16))
    kw = dict(causal=True, window=6, softcap=30.0)
    got = ref.flash_attention_short(q, k, v, **kw)
    kr, vr = (x.repeat_interleave(4, dim=2) for x in (k, v))
    torch.testing.assert_close(got, ref.flash_attention_short(q, kr, vr, **kw),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_on_the_cpu_is_unchanged(causal):
    """At BST's head shape, whose forward the card sends to the short
    kernel: the CPU forward is `ref.flash_attention` and the `Attention`
    Function's gradient `ref.flash_attention_bwd`, bit for bit, with no
    launch; the gradient's route is still the short backward."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 3, 21, 21, 8, 8, 4))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 21, 8, 4))
                         .astype(np.float32))
    assert flash_attention.route(_meta(3, 21, 8, 4), _meta(3, 21, 8, 4),
                                 _meta(3, 21, 8, 4)) == SHORT
    assert flash_backward.route(q, k, v, None) == "flash_backward_short"
    before = dict(_build.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, ref.flash_attention(q, k, v, causal=causal))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    og = ops.flash_attention(*leaves, causal=causal)
    og.backward(g)
    assert torch.equal(og.detach(), out)
    want = ref.flash_attention_bwd(q, k, v, out, g, causal=causal)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    assert _build.LAUNCHES == before
