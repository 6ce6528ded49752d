"""The port's two-pass clause_match and sparse_gain at their edges, on the
CPU, against the reference.

`ref.clause_tokens` (the compact clause table of the CUDA kernel's first
pass) followed by `ref.token_match` (its second pass's subset test) against
the reference's `ops.clause_match` through the Pallas body
(`backend="interpret"`) and the XLA path: empty clauses, clauses of exactly
4 and of 5+ set bits (overflow), a clause on bit 31 of the last word, K = 1,
K = 5000 at Wv = 2, B that no group size divides, and a permutation of the
vocabulary applied to queries and clauses. `clause_match.plan`, the group
size of the second pass, at its shared-memory edge. `sparse_gain` against
the reference just past the shared-memory route's mask limit and at 2^21
docs. Every result is an integer or a bool: all comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import bitset
from repro_torch.kernels import _build
from repro_torch.kernels import clause_match as cm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sparse_gain import SMEM_BYTES, smem_route

BACKENDS = ["interpret", "xla"]


def _t(words):
    return bitset.to_tensor(words, "cpu")


def _edge_clauses(rng, q, wv, empty=False):
    """Clause rows over `wv` words: 1-3 bits, exactly 4, 5 and 9 bits
    (overflow), the last word's bit 31 alone, dense, and with `empty` an
    empty row; half of the sparse ones subsets of a query."""
    nbits = wv * 32
    rows = []
    for n in (1, 1, 2, 3, 4, 4, 5, 5, 9, 9):
        bits = np.zeros(nbits, bool)
        bits[rng.choice(nbits, size=min(n, nbits), replace=False)] = True
        rows.append(bits)
    top = np.zeros(nbits, bool)
    top[nbits - 1] = True                       # bit 31 of the last word
    rows.append(top)
    rows.append(rng.random(nbits) < 0.5)        # dense: overflow, no match
    if empty:
        rows.append(np.zeros(nbits, bool))
    c = jbitset.np_pack(np.stack(rows))
    qb = jbitset.np_unpack(q, nbits)
    for i in range(1, 10, 2):                   # subsets of some query
        pick = qb[rng.integers(len(q))]
        on = np.flatnonzero(pick)
        sub = np.zeros(nbits, bool)
        sub[rng.choice(on, size=min(len(on), int(rows[i].sum())), replace=False)] = True
        c[i] = jbitset.np_pack(sub[None])[0]
    return c


def _queries(rng, b, wv, p=0.35):
    q = jbitset.np_pack(rng.random((b, wv * 32)) < p)
    q[0, -1] |= np.uint32(0x80000000)           # a query holding bit 31 of the last word
    return q


CASES = ["edges", "empty", "k1", "k5000", "ragged_b"]


def _case(name):
    rng = np.random.default_rng(CASES.index(name) + 1)
    if name == "edges":
        q = _queries(rng, 37, 3)
        return q, _edge_clauses(rng, q, 3)
    if name == "empty":                         # matches every query
        q = _queries(rng, 21, 3)
        return q, _edge_clauses(rng, q, 3, empty=True)
    if name == "k1":
        q = _queries(rng, 33, 2)
        return q, jbitset.np_pack(rng.random((1, 64)) < 0.04) & q[5:6]
    if name == "k5000":
        q = _queries(rng, 70, 2, p=0.3)
        q[:, 1] &= np.uint32(0x7FFFFFFF)        # no query holds token 63,
        c = jbitset.np_pack(rng.random((5000, 64)) < 0.05)
        c[:, 1] |= np.uint32(0x80000000)        # which every clause but the last 40 holds
        for i in range(40):                     # 2..9 tokens of query i
            on = np.flatnonzero(jbitset.np_unpack(q[i:i + 1], 64)[0])
            sub = np.zeros(64, bool)
            sub[rng.choice(on, size=2 + i % 8, replace=False)] = True
            c[4960 + i] = jbitset.np_pack(sub[None])[0]
        return q, c
    if name == "ragged_b":
        q = _queries(rng, 133, 5)
        return q, _edge_clauses(rng, q, 5)
    raise KeyError(name)


def test_clause_tokens_table():
    """Positions ascending, -1 past the count, count capped at slots + 1."""
    rows = np.zeros((6, 3), np.uint32)
    rows[1, 0] = 0b1011                          # 3 bits: 0, 1, 3
    rows[2, 1] = 0xF0                            # 4 bits: 36..39
    rows[3, 0], rows[3, 2] = 0x3, 0x80000007     # 6 bits: overflow
    rows[4, 2] = 0x80000000                      # bit 31 of the last word: 95
    rows[5, 0], rows[5, 1], rows[5, 2] = 0x80000000, 1, 0x40000000   # 31, 32, 94
    tokens, count = ref.clause_tokens(_t(rows), slots=4)
    assert tokens.dtype == torch.int32 and count.dtype == torch.int32
    assert count.tolist() == [0, 3, 4, 5, 1, 3]
    assert tokens.tolist() == [[-1, -1, -1, -1], [0, 1, 3, -1], [36, 37, 38, 39],
                               [0, 1, 64, 65], [95, -1, -1, -1], [31, 32, 94, -1]]
    t1, c1 = cm.clause_tokens(_t(rows))          # the wrapper's CPU path
    assert torch.equal(t1, tokens) and torch.equal(c1, count)


def test_compact_table_takes_the_cpu_path_or_raises():
    """On CPU tensors the compact table is the plain version (no launch
    counted); a tensor on another non-CUDA device is refused."""
    _build.reset_launches()
    a = torch.zeros((4, 2), dtype=torch.int32)
    tokens, count = cm.clause_tokens(a)
    assert count.tolist() == [0] * 4 and (tokens == -1).all()
    assert _build.LAUNCHES["clause_match"] == 0
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cm.clause_tokens(meta)


@pytest.mark.parametrize("slots", [1, 2, 4, 7])
def test_clause_tokens_against_numpy(slots):
    rng = np.random.default_rng(slots)
    bits = rng.random((300, 5 * 32)) < rng.random((300, 1)) * 0.06
    tokens, count = ref.clause_tokens(_t(jbitset.np_pack(bits)), slots=slots)
    for row, t, n in zip(bits, tokens.tolist(), count.tolist()):
        on = np.flatnonzero(row)
        assert n == min(len(on), slots + 1)
        want = list(on[:slots]) + [-1] * (slots - min(len(on), slots))
        assert t == want


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_token_test_matches_reference(backend, case):
    q, c = _case(case)
    want = np.asarray(jops.clause_match(jnp.asarray(q), jnp.asarray(c),
                                        backend=backend))
    assert want.all() if case == "empty" else want.any() and not want.all()
    tokens, count = ref.clause_tokens(_t(c))
    got = ref.token_match(_t(q), _t(c), tokens, count)
    assert got.dtype == torch.bool and got.shape == (q.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.clause_match(_t(q), _t(c)).numpy(), want)


def test_overflow_and_empty_clauses_take_their_paths():
    """An empty clause matches every query; an overflow clause whose first 4
    tokens lie in a query but whose 5th does not, does not match it."""
    q = np.zeros((2, 2), np.uint32)
    q[0, 0] = 0b1111                               # tokens 0..3
    q[1, 0] = 0b11111                              # tokens 0..4
    over = np.zeros((1, 2), np.uint32)
    over[0, 0] = 0b11111
    tokens, count = ref.clause_tokens(_t(over))
    assert count.tolist() == [5] and tokens.tolist() == [[0, 1, 2, 3]]
    assert ref.token_match(_t(q), _t(over), tokens, count).tolist() == [False, True]
    empty = np.zeros((1, 2), np.uint32)
    assert ref.token_match(_t(q), _t(empty), *ref.clause_tokens(_t(empty))).tolist() \
        == [True, True]
    for c, want in ((over, [False, True]), (empty, [True, True])):
        np.testing.assert_array_equal(
            np.asarray(jops.clause_match(jnp.asarray(q), jnp.asarray(c),
                                         backend="xla")), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vocabulary_permutation_changes_nothing(backend):
    """The same queries and clauses with the token ids permuted (bits moved
    across words, into and out of bit 31) give the same answers."""
    rng = np.random.default_rng(5)
    q, c = _case("edges")
    nbits = q.shape[1] * 32
    perm = rng.permutation(nbits)

    def moved(words):
        bits = jbitset.np_unpack(words, nbits)
        out = np.zeros_like(bits)
        out[:, perm] = bits
        return jbitset.np_pack(out)

    qp, cp = moved(q), moved(c)
    want = np.asarray(jops.clause_match(jnp.asarray(q), jnp.asarray(c), backend=backend))
    np.testing.assert_array_equal(
        np.asarray(jops.clause_match(jnp.asarray(qp), jnp.asarray(cp), backend=backend)),
        want)
    for qq, cc in ((q, c), (qp, cp)):
        got = ref.token_match(_t(qq), _t(cc), *ref.clause_tokens(_t(cc)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,k,wv", [(4096, 2 ** 16, 4096), (4096, 128, 4096),
                                    (1, 9, cm.MAX_VOCAB_WORDS),
                                    (100, 10 ** 5, cm.MAX_VOCAB_WORDS),
                                    (10 ** 6, 64, 1), (7, 5000, 20000),
                                    (263, 50, 9), (264, 50, 9), (265, 50, 9)])
def test_plan_fills_the_card_within_shared_memory(b, k, wv):
    sms = 132
    qpb = cm.plan(b, k, wv, sms)
    assert 1 <= qpb <= cm.MAX_Q
    assert cm.smem_rows(qpb) * wv * 4 + cm.FLAG_BYTES <= cm.SMEM_BYTES
    assert -(-b // qpb) >= min(b, 2 * sms)       # at least two blocks per SM
    if k * cm.TABLE_BYTES <= wv * 4:              # the table is the smaller read
        assert qpb == 1


def test_plan_at_the_production_shapes():
    # serve_route's 2^16 clauses: 13 queries and their union, 224 KiB, in
    # 316 blocks; the 128 deployed clauses: one query a block
    assert cm.plan(4096, 2 ** 16, 4096, 132) == 13
    assert cm.plan(4096, 128, 4096, 132) == 1


def test_plan_refuses_past_the_vocab_word_limit():
    assert cm.MAX_VOCAB_WORDS * 4 + cm.FLAG_BYTES <= cm.SMEM_BYTES
    with pytest.raises(ValueError, match="shared-memory limit"):
        cm.plan(1, 1, cm.MAX_VOCAB_WORDS + 1, 132)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("w", [SMEM_BYTES // 4 + 1, 2 ** 21 // 32])
def test_sparse_gain_past_the_shared_memory_route(backend, w):
    assert not smem_route(w)
    rng = np.random.default_rng(w)
    c, m = 19, 300
    ids = rng.integers(0, w * 32, size=(c, m)).astype(np.int32)
    ids[rng.random((c, m)) < 0.3] = -1            # padding at random places
    ids[3] = -1                                   # a row of padding only
    ids[4, :5] = w * 32 - 1                       # the last doc, bit 31
    covered = jbitset.np_pack(rng.random(w * 32) < 0.5)
    want = np.asarray(jops.sparse_gain(jnp.asarray(ids), jnp.asarray(covered),
                                       backend=backend))
    np.testing.assert_array_equal(
        want, np.asarray(jref.sparse_gain(jnp.asarray(ids), jnp.asarray(covered))))
    got = ops.sparse_gain(torch.from_numpy(ids), _t(covered))
    assert got.dtype == torch.int32 and got[3] == 0
    np.testing.assert_array_equal(got.numpy(), want)
