"""One-row calls of the port's `partition_gain`: the route a call takes, the
plain version at one row against the reference's ops and its Pallas kernel,
and lazy greedy's exact evaluation under per-shard caps against the
reference's.

On the CUDA card a call of at most `tiles.SPLIT_MAX_TASKS["partition_gain"]`
rows of at least `tiles.SPLIT_MIN_WORDS["partition_gain"]` words, in at most
`tiles.SPLIT_MAX_PARTS` partitions, takes the split route (a row to a
thread-block cluster, a count a partition), any other the warp route;
`chip_smoke.py` holds both routes against the plain version there. Here, on
the CPU, the route is only chosen and checked, and the plain version runs.

One-row operands are sliced at several rows of a larger matrix (a view with
a storage offset, as `_exact_gains_one` slices `clause_doc_bits[j:j + 1]`),
over ragged partitions: P 1 to 32 at random cuts, one-word partitions, cuts
off multiples of 4 words. Every count must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraint as jconstraint
from repro.core.lazy_greedy import _exact_gains_one as ref_exact_gains_one
from repro.core.problem import SCSKProblem as JProblem
from repro.kernels import ops as jops
from repro.kernels import partition_gain as jpg
from repro_torch import convert
from repro_torch.core import constraint, lazy_greedy
from repro_torch.core.lazy_greedy import _exact_gains_one
from repro_torch.kernels import ops, partition_gain, tiles
from repro_torch.kernels.tiles import SPLIT_MAX_PARTS, SPLIT_MAX_TASKS, SPLIT_MIN_WORDS

WIDTHS = [1, 3, 625, 849, 1029, 8193]
ROWS = [0, 4, 8]             # rows sliced from a [9, W] matrix
KINDS = ["p1", "p2", "p3", "p8", "p32", "one_word", "off4"]


def _words(rng, c, w):
    a = rng.integers(0, 2 ** 32, size=(c, w), dtype=np.uint32)
    a[:, -1] |= np.uint32(0x80000000)         # bit 31 of the last word
    return a


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _bounds(rng, w, kind):
    """P+1 word offsets of a `w`-word row: P random cuts ("p<P>"), 7
    one-word partitions then the rest ("one_word"), or up to 32 cuts one
    word past multiples of 4 ("off4")."""
    if kind == "one_word":
        return (0, *range(1, 8), w)
    if kind == "off4":
        return (0, *range(5, min(w, 8 * 32), 8), w)
    cuts = rng.choice(np.arange(1, w), size=int(kind[1:]) - 1, replace=False)
    return (0, *sorted(int(c) for c in cuts), w)


def _cases():
    """(w, kind) pairs whose partitions fit in `w` words."""
    out = []
    for w in WIDTHS:
        for kind in KINDS:
            p = {"one_word": 8, "off4": 2}.get(kind) or int(kind[1:])
            if p <= w and not (kind == "off4" and w < 6):
                out.append((w, kind))
    return out


# -- the route ----------------------------------------------------------------

def test_the_limits_are_the_sweep():
    """Per-shard greedy's and optpes's rows stay on the warp route; lazy's
    and ingest's one row takes the split route at the production width
    (32768 words, phase 3's 8 shards); `medium`'s 625 doc words stay on the
    warp route at any partition count."""
    assert SPLIT_MAX_TASKS["partition_gain"] == 128
    assert SPLIT_MIN_WORDS["partition_gain"] == 8192
    assert not hasattr(tiles, "SPLIT_MIN_PARTS")
    assert SPLIT_MAX_PARTS == 1024
    route = tiles.gain_route
    assert route("partition_gain", 65536, 32768, 8) == "warp"
    assert route("partition_gain", 4096, 32768, 8) == "warp"
    assert route("partition_gain", 1, 32768, 8) == "split"
    assert route("partition_gain", 1, 32768, 1) == "split"
    assert route("partition_gain", 1, 625, 4) == "warp"
    assert route("partition_gain", 1, 625, 8) == "warp"
    assert route("partition_gain", 1, 625, 32) == "warp"
    assert route("partition_gain", 1023, 625, 8) == "warp"


@pytest.mark.parametrize("w", [1, 625, 8191, 8192, 8193, 32768, 40003])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_gain_route_at_the_limits(w, edge):
    wide = w >= SPLIT_MIN_WORDS["partition_gain"]
    # rows: the split route from the least width, up to the most rows
    tasks = SPLIT_MAX_TASKS["partition_gain"] + edge
    for p in (1, 8, 32):
        assert tiles.gain_route("partition_gain", tasks, w, p) == (
            "split" if wide and edge <= 0 else "warp")
    # partitions at their largest count: the warp route above it
    assert tiles.gain_route("partition_gain", 1, w, SPLIT_MAX_PARTS + edge) == (
        "split" if wide and edge <= 0 else "warp")


def test_the_other_kernels_take_one_partition():
    """`parts` defaults to 1, so coverage_gain's and bit_matvec's routes
    stay as their limits set them."""
    for k in ("coverage_gain", "bit_matvec"):
        assert tiles.gain_route(k, 1, 32768) == "split"
        assert tiles.gain_route(k, 1, 32768, SPLIT_MAX_PARTS + 1) == "warp"


@pytest.mark.parametrize("route", ["rows", "", 1, "Split"])
def test_a_route_outside_the_routes_raises(route):
    rng = np.random.default_rng(0)
    a, m = _t(_words(rng, 1, 3)), _t(_words(rng, 1, 3))[0]
    with pytest.raises(ValueError, match="route"):
        partition_gain.partition_gain(a, m, (0, 1, 3), route=route)
    with pytest.raises(ValueError, match="route"):
        partition_gain.partition_gain(a.to("meta"), m.to("meta"), (0, 1, 3), route=route)


@pytest.mark.parametrize("route", [None, "warp", "split"])
@pytest.mark.parametrize("warps", tiles.WARPS)
def test_the_plain_version_ignores_route_and_warps(route, warps):
    rng = np.random.default_rng(1)
    a, m = _t(_words(rng, 3, 11)), _t(_words(rng, 1, 11))[0]
    bounds = (0, 1, 2, 7, 11)
    want = partition_gain.partition_gain(a, m, bounds)
    assert torch.equal(partition_gain.partition_gain(a, m, bounds, route=route, warps=warps),
                       want)
    got = partition_gain.partition_gain(a.to("meta"), m.to("meta"), bounds, route=route,
                                        warps=warps)
    assert got.shape == (3, 4) and got.dtype == torch.int32


def test_check_bounds_normalises_and_refuses():
    """`check_bounds` returns the offsets as a tuple of ints; any other
    width or a bad list is refused."""
    b = partition_gain.check_bounds(np.array([0, 3, 9]), 9)
    assert type(b) is tuple and b == (0, 3, 9) and all(type(x) is int for x in b)
    with pytest.raises(ValueError, match="bounds"):
        partition_gain.check_bounds(b, 10)
    for bad in [(0, 3), (1, 9), (0, 3, 3, 9), (0,)]:
        with pytest.raises(ValueError, match="bounds"):
            partition_gain.check_bounds(bad, 9)


# -- the plain version at one row against the reference -------------------------

@pytest.mark.parametrize("w,kind", _cases())
def test_partition_gain_one_row_matches_reference(w, kind):
    rng = np.random.default_rng(w * 10 + KINDS.index(kind))
    a, mask = _words(rng, 9, w), _words(rng, 1, w)[0]
    bounds = _bounds(rng, w, kind)
    ta, tm = _t(a), _t(mask[None])[0]
    for j in ROWS:
        want = jops.partition_gain(jnp.asarray(a[j][None]), jnp.asarray(mask), bounds,
                                   backend="xla")
        got = ops.partition_gain(ta[j:j + 1], tm, bounds)
        assert got.shape == (1, len(bounds) - 1) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w", WIDTHS)
def test_partition_gain_one_row_matches_the_pallas_kernel(w):
    """Against the Pallas kernel in interpret mode (its f32 sums are exact
    below 2^24 docs), over the widest ragged partition of each width."""
    rng = np.random.default_rng(500 + w)
    a, mask = _words(rng, 9, w), _words(rng, 1, w)[0]
    kind = "p32" if w >= 32 else "p3" if w >= 3 else "p1"
    bounds = _bounds(rng, w, kind)
    ta, tm = _t(a), _t(mask[None])[0]
    for j in ROWS:
        want = jpg.partition_gain(jnp.asarray(a[j][None]), jnp.asarray(mask), bounds,
                                  interpret=True)
        got = partition_gain.partition_gain(ta[j:j + 1], tm, bounds, route="split")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w,kind", [(625, "p8"), (849, "one_word"), (1029, "off4")])
def test_out_receives_the_counts(w, kind):
    """`out=` (here a view at a storage offset, as `_exact_gains_one` passes
    one) is filled and returned, through the wrapper and through `ops`."""
    rng = np.random.default_rng(w)
    a, mask = _t(_words(rng, 2, w)), _t(_words(rng, 1, w))[0]
    bounds = _bounds(rng, w, kind)
    p = len(bounds) - 1
    want = ops.partition_gain(a[1:], mask, bounds)
    for fn in (ops.partition_gain, partition_gain.partition_gain):
        buf = torch.full((1 + p,), -7, dtype=torch.int32)
        got = fn(a[1:], mask, bounds, out=buf[1:][None])
        assert got.data_ptr() == buf[1:].data_ptr() and torch.equal(got, want)
        assert buf[0] == -7


# -- lazy greedy's exact evaluation under per-shard caps --------------------------

C, WQ, WD = 24, 5, 40
N_QUERIES, N_DOCS = WQ * 32 - 3, WD * 32 - 5
SPLITS = {
    "one_part": (0, WD),
    "ragged": (0, 1, 2, 3, 11, 13, 29, WD),
    "p32": (0, *range(1, 32), WD),
}


def _problem_arrays(seed):
    rng = np.random.default_rng(seed)
    q = np.packbits(rng.random((C, WQ * 32)) < 0.08, axis=1, bitorder="little")
    d = np.packbits(rng.random((C, WD * 32)) < 0.1, axis=1, bitorder="little")
    q = q.view(np.uint32).copy()
    d = d.view(np.uint32).copy()
    w = np.zeros(WQ * 32, np.float32)
    w[:N_QUERIES] = rng.integers(1, 64, N_QUERIES) / 4096
    t = np.zeros(WQ * 32, np.float32)
    t[:N_QUERIES] = rng.integers(1, 64, N_QUERIES) / 4096
    return q, d, w, t


class _Calls:
    """Records each call of an op and whether it was given `out`."""

    def __init__(self, fn):
        self.fn, self.outs = fn, []

    def __call__(self, *args, **kw):
        self.outs.append(kw.get("out") is not None)
        return self.fn(*args, **kw)


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("kept", [(), (3,), (0, 7, 19)])
def test_exact_gains_one_under_caps_matches_reference(monkeypatch, split, kept):
    """Bit-equal to the reference's evaluation, from one `bit_matvec` and one
    `partition_gain` call that both write the one buffer read to the host
    (no `torch.cat`)."""
    q, d, w, t = _problem_arrays(11)
    jp = JProblem(clause_query_bits=jnp.asarray(q), clause_doc_bits=jnp.asarray(d),
                  query_weights=jnp.asarray(w), test_weights=jnp.asarray(t),
                  n_queries=N_QUERIES, n_docs=N_DOCS)
    tp = convert.problem_from_numpy(q, d, w, t, N_QUERIES, N_DOCS, device="cpu")
    bounds = SPLITS[split]
    caps = [float(10 + k) for k in range(len(bounds) - 1)]
    jc = jconstraint.PartitionedBudget(caps=caps, bounds=bounds)
    tc = constraint.PartitionedBudget(caps, bounds)
    cq = np.bitwise_or.reduce(q[list(kept)], axis=0) if kept else np.zeros(WQ, np.uint32)
    cd = np.bitwise_or.reduce(d[list(kept)], axis=0) if kept else np.zeros(WD, np.uint32)
    tcq = convert.state_from_numpy(cq, cd, np.zeros(C, bool), 0.0, 0, device="cpu")
    x = tp.uncovered_weights(tcq.covered_q)
    calls = {k: _Calls(getattr(ops, k)) for k in ("bit_matvec", "partition_gain",
                                                  "coverage_gain")}
    for k, spy in calls.items():
        monkeypatch.setattr(lazy_greedy.ops, k, spy)
    monkeypatch.setattr(torch, "cat", None)
    for j in range(C):
        want_f, want_g = ref_exact_gains_one(jp, jc, jnp.asarray(cq), jnp.asarray(cd), j)
        got_f, got_g = _exact_gains_one(tp, tc, x, tcq.covered_d, j)
        assert got_f == float(want_f)
        assert got_g.dtype == np.float64 and got_g.shape == (len(bounds) - 1,)
        np.testing.assert_array_equal(got_g, np.asarray(want_g, np.float64))
    assert calls["bit_matvec"].outs == calls["partition_gain"].outs == [True] * C
    assert calls["coverage_gain"].outs == []


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_gain_counts_are_the_gains_before_the_cast(split):
    """`gain_counts` gives `gains`' per-partition costs as the kernel's
    int32 counts, for a partitioned budget and the global one, into `out`
    when given."""
    q, d, w, t = _problem_arrays(5)
    tp = convert.problem_from_numpy(q, d, w, t, N_QUERIES, N_DOCS, device="cpu")
    cd = tp.clause_doc_bits[2] | tp.clause_doc_bits[9]
    bounds = SPLITS[split]
    for cons in (constraint.PartitionedBudget([5.0] * (len(bounds) - 1), bounds),
                 constraint.GlobalBudget(50.0)):
        _, want = cons.gains(tp, cd)
        got = cons.gain_counts(tp, cd)
        assert got.dtype == torch.int32 and torch.equal(got.to(torch.float32), want)
        out = torch.empty((3, cons.n_parts), dtype=torch.int32)
        assert cons.gain_counts(tp, cd, rows=tp.clause_doc_bits[4:7], out=out) is out
        assert torch.equal(out, got[4:7])
