"""The port's tile autotuner (`repro_torch.kernels.autotune`) against the
reference's (`repro.kernels.autotune`, `tests/test_autotune.py`): the same
buckets, the cache's miss / disable / key-stripping through the port's own
variable, the search's picks, interleaved order and ties (on a patched CPU
space with a fake clock: the real spaces are the CUDA kernels', timed only
on a card), the same synthetic draws, and the ops dispatch passing a cached
tile through `ExecutionPlan.tile_params` to the wrapper with results equal
to the reference's `ref.*`. A tile out of its op's space raises before any
launch; without a card the default search raises and writes nothing."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import distributed
from repro_torch.kernels import _build, autotune, ops
from repro_torch.kernels import bit_matvec as tbm
from repro_torch.kernels import clause_match as tcm
from repro_torch.kernels import coverage_gain as tcg
from repro_torch.kernels import partition_gain as tpg

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_cache_state(monkeypatch, tmp_path):
    # the default cache path is relative: keep a checkout's artifacts/ out
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(autotune.ENV_VAR, raising=False)
    autotune.invalidate()
    yield
    autotune.invalidate()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


DIMS = [("clause_match", (512, 128, 64)), ("clause_match", (300, 100, 33)),
        ("clause_match", (4096, 65536, 4096)), ("bit_matvec", (4096, 512, 1)),
        ("bit_matvec", (65, 9, 3)), ("bit_matvec", (1, 32768, 1)),
        ("coverage_gain", (65536, 32768)), ("coverage_gain", (1023, 625)),
        ("partition_gain", (4096, 512, 4)), ("partition_gain", (1, 625, 4)),
        ("fused_match", (4096, 8, 32768))]


def test_pow2_bucketing_is_stable():
    assert autotune.bucket("clause_match", 512, 128, 64) == "b512_k128_w64"
    assert autotune.bucket("clause_match", 300, 100, 33) == "b512_k128_w64"
    assert autotune.bucket("bit_matvec", 4096, 512, 1) == "c4096_w512_r1"
    assert autotune.bucket("partition_gain", 4096, 512, 4) == "c4096_w512_p4"
    for op, dims in DIMS:
        assert autotune.bucket(op, *dims) == jautotune.bucket(op, *dims)


def test_bucket_from_args_matches_bucket():
    shapes = {"clause_match": ((300, 33), (100, 33)),
              "bit_matvec": ((65, 9), (9 * 32, 3)),
              "coverage_gain": ((65, 9), (9,)),
              "sparse_gain": ((65, 9), (9 * 32, 3))}
    for op, (sa, sb) in shapes.items():
        targs = (torch.zeros(sa, dtype=torch.int32), torch.zeros(sb))
        jargs = (jnp.zeros(sa, jnp.uint32), jnp.zeros(sb, jnp.float32))
        assert autotune.bucket_from_args(op, targs) \
            == jautotune.bucket_from_args(op, jargs)
    q = torch.zeros((300, 33), dtype=torch.int32)
    c = torch.zeros((100, 33), dtype=torch.int32)
    assert autotune.bucket_from_args("clause_match", (q, c)) == "b512_k128_w64"
    a = torch.zeros((65, 9), dtype=torch.int32)
    x = torch.zeros((9 * 32, 3))
    assert autotune.bucket_from_args("bit_matvec", (a, x)) == "c128_w16_r4"
    assert autotune.bucket_from_args("bit_matvec", (a, x[:, 0])) == "c128_w16_r1"
    assert autotune.bucket_from_args("sparse_gain", (a, x)) is None
    assert autotune.bucket_from_args("partition_gain", (a, x)) is None


def test_tile_params_miss_and_disable(tmp_path, monkeypatch):
    path = tmp_path / "tiles_torch.json"
    path.write_text(json.dumps({
        "version": autotune.CACHE_VERSION,
        "entries": {"clause_match|cuda|b8_k8_w1":
                    {"qpb": 4, "_ms": 0.012, "_default_ms": 0.02}}}))
    # the reference's variable names no cache of the port
    monkeypatch.setenv(jautotune.ENV_VAR, str(path))
    assert autotune.tile_params("clause_match", "cuda", "b8_k8_w1") == {}
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.invalidate()
    assert autotune.ENV_VAR == "REPRO_TORCH_KERNEL_TILES"
    assert autotune.cache_path() == str(path)
    got = autotune.tile_params("clause_match", "cuda", "b8_k8_w1")
    assert got == {"qpb": 4}                    # bookkeeping keys dropped
    got["qpb"] = 1                              # a copy: the memo keeps its own
    assert autotune.tile_params("clause_match", "cuda", "b8_k8_w1") == {"qpb": 4}
    assert autotune.tile_params("clause_match", "cuda", "b16_k8_w1") == {}
    assert autotune.tile_params("clause_match", "cpu", "b8_k8_w1") == {}
    assert autotune.tile_params("clause_match", "cuda", None) == {}
    for off in ("0", "off", "none", "false", " OFF "):
        monkeypatch.setenv(autotune.ENV_VAR, off)
        assert autotune.tile_params("clause_match", "cuda", "b8_k8_w1") == {}
        assert autotune.cache_path() == autotune.DEFAULT_CACHE
    # another version of the cache is no cache
    path.write_text(json.dumps({"version": 99, "entries": {
        "clause_match|cuda|b8_k8_w1": {"qpb": 4}}}))
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.invalidate()
    assert autotune.tile_params("clause_match", "cuda", "b8_k8_w1") == {}


class _Spy:
    """Wraps a wrapper; records the tile keywords of every call."""

    def __init__(self, fn, key):
        self.fn, self.key, self.seen = fn, key, []

    def __call__(self, *args, **kw):
        self.seen.append(kw.get(self.key))
        return self.fn(*args, **kw)


class _FakeClock:
    """A clock read twice a trial: the second read advances it by the
    duration of the candidate the spy saw last."""

    def __init__(self, spy, durations):
        self.spy, self.durations, self.t, self.open = spy, durations, 0.0, False

    def __call__(self):
        if self.open:
            self.t += self.durations[self.spy.seen[-1]]
        self.open = not self.open
        return self.t


def test_search_writes_picks_from_the_candidate_space(tmp_path, monkeypatch):
    """A CPU space patched in (the real ones are CUDA's): the search runs
    the default and every candidate once, then times them round robin
    (default, 1, 2, 8, default, 1, 2, 8, ...); warps 1 and 2 tie at the
    fastest time and the earlier wins; the pick round-trips through
    `tile_params`."""
    space = [{"warps": 1}, {"warps": 2}, {"warps": 8}]
    monkeypatch.setitem(autotune.SPACES, ("coverage_gain", "cpu"), space)
    spy = _Spy(tcg.coverage_gain, "warps")
    monkeypatch.setattr(tcg, "coverage_gain", spy)
    monkeypatch.setattr(autotune, "_clock",
                        _FakeClock(spy, {None: 5 / 1024, 1: 3 / 1024,
                                         2: 3 / 1024, 8: 4 / 1024}))  # exact sums
    out = tmp_path / "tiles_torch.json"
    blob = autotune.search([("coverage_gain", "cpu", (64, 4)),
                            ("sparse_gain", "cpu", (64, 4))],   # no space: skipped
                           seed=0, reps=3, out=str(out))
    assert spy.seen == [None, 1, 2, 8] * 4
    assert out.exists() and json.loads(out.read_text()) == blob
    assert blob["device"] == "cpu" and blob["version"] == autotune.CACHE_VERSION
    entry = blob["entries"]["coverage_gain|cpu|c64_w4"]
    assert set(blob["entries"]) == {"coverage_gain|cpu|c64_w4"}
    assert entry == {"warps": 1, "_ms": 3e3 / 1024, "_default_ms": 5e3 / 1024,
                     "_calls": 1}
    assert {k: v for k, v in entry.items() if not k.startswith("_")} in space
    monkeypatch.setenv(autotune.ENV_VAR, str(out))
    assert autotune.tile_params("coverage_gain", "cpu", "c64_w4") == {"warps": 1}


def test_search_keeps_the_default_where_no_candidate_beats_it(tmp_path, monkeypatch):
    """The default call (clause_match's `plan` pick, which may lie outside
    the space) is timed first in each round: a candidate that only ties it
    is not picked, and the entry holds no tile, so the lookup keeps the
    default."""
    monkeypatch.setitem(autotune.SPACES, ("clause_match", "cpu"),
                        [{"qpb": 1}, {"qpb": 2}])
    spy = _Spy(tcm.clause_match, "qpb")
    monkeypatch.setattr(tcm, "clause_match", spy)
    monkeypatch.setattr(autotune, "_clock", _FakeClock(
        spy, {None: 2 / 1024, 1: 2 / 1024, 2: 3 / 1024}))
    out = tmp_path / "t.json"
    blob = autotune.search([("clause_match", "cpu", (8, 4, 2))], reps=3,
                           out=str(out))
    entry = blob["entries"]["clause_match|cpu|b8_k4_w2"]
    assert entry == {"_ms": 2e3 / 1024, "_default_ms": 2e3 / 1024, "_calls": 1}
    monkeypatch.setenv(autotune.ENV_VAR, str(out))
    assert autotune.tile_params("clause_match", "cpu", "b8_k4_w2") == {}


def test_search_keeps_clause_match_picks_that_fit_the_bucket_edge(tmp_path,
                                                                  monkeypatch):
    """At Wv 3000 (bucket edge 4096) only qpb <= 13 stage their rows in
    shared memory at every Wv of the bucket: 16 and 32 are never run, and
    the fastest of the others is picked (a fake clock makes qpb 8 so)."""
    monkeypatch.setitem(autotune.SPACES, ("clause_match", "cpu"),
                        [{"qpb": q} for q in tcm.QPB])
    spy = _Spy(tcm.clause_match, "qpb")
    monkeypatch.setattr(tcm, "clause_match", spy)
    monkeypatch.setattr(autotune, "_clock", _FakeClock(
        spy, {None: 5 / 1024, 1: 4 / 1024, 2: 3 / 1024, 4: 2 / 1024,
              8: 1 / 1024, 16: 0.0, 32: 0.0}))
    blob = autotune.search([("clause_match", "cpu", (8, 4, 3000))], reps=1,
                           out=str(tmp_path / "t.json"))
    assert spy.seen == [None, 1, 2, 4, 8] * 2
    assert blob["entries"]["clause_match|cpu|b8_k4_w4096"]["qpb"] == 8


def test_search_refuses_a_candidate_that_changes_the_result(tmp_path, monkeypatch):
    monkeypatch.setitem(autotune.SPACES, ("coverage_gain", "cpu"),
                        [{"warps": 1}, {"warps": 2}])
    real = tcg.coverage_gain

    def wrong(a, m, *, warps=8):
        out = real(a, m, warps=warps)
        return out + 1 if warps == 2 else out
    monkeypatch.setattr(tcg, "coverage_gain", wrong)
    out = tmp_path / "t.json"
    with pytest.raises(AssertionError, match="differs"):
        autotune.search([("coverage_gain", "cpu", (16, 4))], reps=1, out=str(out))
    assert not out.exists()


def test_search_calls_check_on_every_output(tmp_path, monkeypatch):
    monkeypatch.setitem(autotune.SPACES, ("partition_gain", "cpu"),
                        [{"warps": 4}, {"warps": 32}])
    seen = []

    def check(op, dims, args, params, out):
        a, m, bounds = args
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jops._partition_gain_xla(
                jnp.asarray(a.numpy().view(np.uint32)),
                jnp.asarray(m.numpy().view(np.uint32)), bounds)))
        seen.append(params)
    autotune.search([("partition_gain", "cpu", (40, 24, 3))], reps=1,
                    out=str(tmp_path / "t.json"), check=check)
    assert seen == [{}, {"warps": 4}, {"warps": 32}]


def test_ensure_cache_respects_disable(monkeypatch):
    monkeypatch.setenv(autotune.ENV_VAR, "0")
    path, n = autotune.ensure_cache()
    assert path == "<disabled>" and n == 0


def test_default_search_raises_without_a_card(tmp_path, monkeypatch, capsys):
    """The default workload times the CUDA kernels: without a card the
    search raises, `main` exits non-zero with the reason, and nothing is
    written; there is no CPU tuning."""
    assert all(path == "cuda" for _, path, _ in autotune.DEFAULT_WORKLOAD)
    assert {op for op, _ in autotune.SPACES} == {
        "coverage_gain", "bit_matvec", "partition_gain", "clause_match"}
    assert all(path == "cuda" for _, path in autotune.SPACES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "tiles_torch.json"
    with pytest.raises(RuntimeError, match="needs a card"):
        autotune.search(out=str(out))
    assert autotune.main(["--out", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
    monkeypatch.setenv(autotune.ENV_VAR, str(out))
    with pytest.raises(RuntimeError, match="needs a card"):
        autotune.ensure_cache()
    assert not out.exists()


def test_cli_without_a_card_exits_non_zero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.kernels.autotune",
                          "--out", str(tmp_path / "t.json")], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "t.json").exists()
    assert not (tmp_path / autotune.DEFAULT_CACHE).exists()


@pytest.mark.parametrize("op,dims", [
    ("clause_match", (12, 7, 3)), ("clause_match", (300, 100, 33)),
    ("bit_matvec", (5, 3, 2)), ("coverage_gain", (5, 3)),
    ("partition_gain", (6, 6, 2)), ("partition_gain", (9, 4, 3))])
def test_synth_matches_reference(op, dims):
    """The same numpy draws from the same seed, as uint32 and as the int32
    tensors the wrappers take. partition_gain's bounds are word offsets
    over W here (the reference spaces them over C; equal when C == W)."""
    want = jautotune._synth(op, dims, 3)
    got = autotune._synth(op, dims, 3)
    assert len(got) == len(want)
    dev = autotune._device_args(got, torch.device("cpu"), {})
    for g, w, d in zip(got, want, dev):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            if w.dtype == np.uint32:
                assert d.dtype == torch.int32
                np.testing.assert_array_equal(d.numpy(), w.view(np.int32))
                np.testing.assert_array_equal(d.numpy().view(np.uint32), w)
            else:
                np.testing.assert_array_equal(d.numpy(), w)
    if op == "partition_gain":
        c, w, p = dims
        assert got[2] == tuple(int(v) for v in np.linspace(0, w, p + 1).astype(int))
        assert (got[2] == want[2]) == (c == w)


def test_synth_memo_draws_the_same_operands():
    """One search's memo: the three gain ops of one (seed, C, W) share the
    first draw and still get the reference's operands."""
    memo = {}
    for op, dims in (("coverage_gain", (6, 5)), ("partition_gain", (6, 5, 2)),
                     ("bit_matvec", (6, 5, 2)), ("coverage_gain", (6, 5))):
        got = autotune._synth(op, dims, 1, memo)
        for g, w in zip(got, jautotune._synth(op, dims, 1)):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
    assert len(memo["rows"]) == 1
    a = memo["rows"][(1, 6, 5)][0]
    first = autotune._device_args((a,), torch.device("cpu"), memo)[0]
    assert autotune._device_args((a,), torch.device("cpu"), memo)[0] is first


@pytest.mark.parametrize("call", [
    lambda a, m, q, c, x: tcg.coverage_gain(a, m, warps=3),
    lambda a, m, q, c, x: tcg.coverage_gain(a, m, warps=0),
    lambda a, m, q, c, x: tcg.coverage_gain(a, m, warps=64),
    lambda a, m, q, c, x: tcg.coverage_gain(a, m, warps=True),
    lambda a, m, q, c, x: tbm.bit_matvec(a, x, warps=12),
    lambda a, m, q, c, x: tpg.partition_gain(a, m, (0, 2, 4), warps=5),
    lambda a, m, q, c, x: tcm.clause_match(q, c, qpb=3),
    lambda a, m, q, c, x: tcm.clause_match(q, c, qpb=64),
    lambda a, m, q, c, x: tcm.clause_match(q, c, qpb=0),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_out_of_space_tile_raises_before_any_launch(call, device, monkeypatch):
    """On either device (meta tensors stand in for the card's: they take the
    kernel's side of the wrapper), before any launch."""
    launches = []
    monkeypatch.setattr(_build, "launch", lambda *a, **k: launches.append(a))
    a = torch.zeros((3, 4), dtype=torch.int32, device=device)
    m = torch.zeros(4, dtype=torch.int32, device=device)
    q = torch.zeros((5, 4), dtype=torch.int32, device=device)
    c = torch.zeros((2, 4), dtype=torch.int32, device=device)
    x = torch.zeros((128, 1), device=device)
    with pytest.raises(ValueError, match="must be one of"):
        call(a, m, q, c, x)
    assert launches == []


def test_qpb_that_does_not_fit_the_call_raises():
    """A qpb of the space whose staged rows pass shared memory at the call's
    Wv raises; it is not replaced by one that fits."""
    wv = 4096
    q = torch.zeros((5, wv), dtype=torch.int32)
    c = torch.zeros((2, wv), dtype=torch.int32)
    assert tcm.fits(8, wv) and not tcm.fits(16, wv)
    for qpb in (1, 2, 4, 8):    # the plain version: empty clauses match all
        assert bool(tcm.clause_match(q, c, qpb=qpb).all())
    for qpb in (16, 32):
        with pytest.raises(ValueError, match="shared memory"):
            tcm.clause_match(q, c, qpb=qpb)
    big = torch.zeros((1, tcm.MAX_VOCAB_WORDS + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        tcm.clause_match(big, big, qpb=1)


def test_a_bad_cache_entry_raises_and_is_not_replaced(tmp_path, monkeypatch):
    """No fallback: a cached tile outside its op's space, a reference-style
    key the wrapper does not take, or a qpb that does not fit the call's Wv
    raises at dispatch."""
    a = torch.zeros((5, 3), dtype=torch.int32)
    q = torch.zeros((5, 4096), dtype=torch.int32)
    cases = [("coverage_gain|cpu|c8_w4", {"warps": 3}, ValueError,
              lambda: ops.coverage_gain(a, a[0])),
             ("coverage_gain|cpu|c8_w4", {"block_c": 64}, TypeError,
              lambda: ops.coverage_gain(a, a[0])),
             ("clause_match|cpu|b8_k8_w4096", {"qpb": 16}, ValueError,
              lambda: ops.clause_match(q, q))]
    for key, tile, err, call in cases:
        path = tmp_path / "tiles_torch.json"
        path.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                    "entries": {key: tile}}))
        monkeypatch.setenv(autotune.ENV_VAR, str(path))
        autotune.invalidate()
        with pytest.raises(err):
            call()
    monkeypatch.setenv(autotune.ENV_VAR, "off")
    assert ops.coverage_gain(a, a[0]).tolist() == [0] * 5


def test_autotuned_picks_are_parity_exact(tmp_path, monkeypatch):
    """Dispatching through ops with a cache of non-default tiles: each op's
    lookup goes through `ExecutionPlan.tile_params` to its wrapper (a spy
    sees the tile), and the results equal the reference's `ref.*`."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 2**32, (300, 33), dtype=np.uint32)
    cl = jbitset.np_pack(rng.random((100, 33 * 32)) < 0.03)
    a = rng.integers(0, 2**32, (65, 9), dtype=np.uint32)
    x = rng.standard_normal((9 * 32, 3)).astype(np.float32)
    mask = rng.integers(0, 2**32, 9, dtype=np.uint32)
    bounds = (0, 3, 7, 9)
    entries = {
        "clause_match|cpu|b512_k128_w64": {"qpb": 2, "_ms": 1.0},
        "bit_matvec|cpu|c128_w16_r4": {"warps": 4},
        "coverage_gain|cpu|c128_w16": {"warps": 2},
        "partition_gain|cpu|c128_w16_p4": {"warps": 16},
    }
    path = tmp_path / "tiles_torch.json"
    path.write_text(json.dumps(
        {"version": autotune.CACHE_VERSION, "entries": entries}))
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    autotune.invalidate()
    spies = {}
    for mod, name, key in ((tcm, "clause_match", "qpb"), (tbm, "bit_matvec", "warps"),
                           (tcg, "coverage_gain", "warps"),
                           (tpg, "partition_gain", "warps")):
        spies[name] = _Spy(getattr(mod, name), key)
        monkeypatch.setattr(mod, name, spies[name])

    plan = distributed.current_plan()
    assert plan.tile_params(
        "bit_matvec", "cpu",
        autotune.bucket_from_args("bit_matvec", (_t(a), _t(x)))) == {"warps": 4}
    assert plan.tile_params("bit_matvec", "cpu", None) == {}

    np.testing.assert_array_equal(
        ops.clause_match(_t(q), _t(cl)).numpy(),
        np.asarray(jref.clause_match(jnp.asarray(q), jnp.asarray(cl))))
    np.testing.assert_allclose(
        ops.bit_matvec(_t(a), _t(x)).numpy(),
        np.asarray(jref.bit_matvec(jnp.asarray(a), jnp.asarray(x))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        ops.coverage_gain(_t(a), _t(mask)).numpy(),
        np.asarray(jref.coverage_gain(jnp.asarray(a), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        ops.partition_gain(_t(a), _t(mask), bounds).numpy(),
        np.asarray(jops._partition_gain_xla(jnp.asarray(a), jnp.asarray(mask),
                                            bounds)))
    assert {k: s.seen for k, s in spies.items()} == {
        "clause_match": [2], "bit_matvec": [4], "coverage_gain": [2],
        "partition_gain": [16]}
    # a miss and the cache turned off keep the wrapper's defaults
    ops.coverage_gain(_t(a[:3]), _t(mask))
    monkeypatch.setenv(autotune.ENV_VAR, "off")
    ops.coverage_gain(_t(a), _t(mask))
    assert spies["coverage_gain"].seen == [2, None, None]
    # the mesh path of partition_gain is not tuned
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    with distributed.use_mesh(distributed.shard_mesh(2, "cpu")):
        got = ops.partition_gain(_t(a), _t(mask), bounds)
    assert spies["partition_gain"].seen == [16, None, None]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops._partition_gain_xla(
        jnp.asarray(a), jnp.asarray(mask), bounds)))


_ISOLATION = r"""
import sys
import repro_torch.kernels.autotune, repro_torch.kernels.ops
import repro_torch.distributed.plan
import repro_torch.configs.gemma3_12b, repro_torch.configs.internlm2_1_8b
from repro_torch.configs import registry
registry.get_arch("gemma3-12b"); registry.get_arch("internlm2-1.8b")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
"""


def test_autotune_and_its_users_import_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
