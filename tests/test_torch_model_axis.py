"""The solvers' "model"-axis path of the port (`distributed.plan`'s
`place`, `axis_rank`, `owner_select`, `owner_row`, `model_gains`; the fused
`optpes` gains and rows, the sparse round's f-gains and rows, the
tiering-scsk dense round) on (data, model) meshes of four CPU entries,
against the port's direct path, the reference's direct path, and the
reference's fused `shard_map` path on four XLA host devices (a subprocess,
as tests/test_multidevice.py runs its mesh; the reference's sparse round
only at (1, 4): it raises where the data axes exceed 1).

Weights are counts over 2^10, so every f sum is exact in f32 whatever its
order and every result is equal bit for bit."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import distributed as D
from repro_torch.configs import tiering_scsk as T
from repro_torch.core import optpes as topt
from repro_torch.core.problem import SCSKProblem

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MESHES = [(1, 4), (2, 2), (4, 1)]
C, NQ, ND, M, K = 256, 1024, 2048, 64, 16


@pytest.fixture(autouse=True)
def refresh_k(monkeypatch):
    """Opt/Pes's batch width K at these sizes, in both packages' configs."""
    from repro.configs import tiering_scsk as RT
    monkeypatch.setattr(T, "CONFIG", T.TieringScaleConfig(refresh_k=K))
    monkeypatch.setattr(RT, "CONFIG", RT.TieringScaleConfig(refresh_k=K))


def mesh_of(dims):
    return D.Mesh(("data", "model"), (CPU,) * 4, dims)


def make_batch(seed: int = 0) -> dict:
    """numpy inputs of every round: sparse random words, count weights."""
    rng = np.random.default_rng(seed)

    def words(shape, p):
        bits = rng.random(shape + (32,)) < p
        return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)

    a_q, a_d = words((C, NQ // 32), 0.05), words((C, ND // 32), 0.03)
    ids = np.full((C, M), -1, np.int32)
    for c in range(C):
        n = rng.integers(1, M + 1)
        ids[c, :n] = np.sort(rng.choice(ND, n, replace=False))
    sel = np.zeros(C, bool)
    sel[rng.choice(C, 8, replace=False)] = True
    return {"clause_query_bits": a_q, "clause_doc_bits": a_d, "clause_doc_ids": ids,
            "query_weights": (rng.integers(0, 16, NQ) / 1024).astype(np.float32),
            "covered_q": words((NQ // 32,), 0.1), "covered_d": words((ND // 32,), 0.1),
            "selected": sel, "g_used": np.float32(40.0), "budget": np.float32(ND // 3)}


def optpes_bounds(b: dict) -> dict:
    """Exact singleton gains as the warm start's bounds (fbar = flow, gbar =
    glow), from the reference's numpy arithmetic."""
    unc = ~np.unpackbits(b["covered_q"].view(np.uint8), bitorder="little").astype(bool)
    a_q = np.unpackbits(b["clause_query_bits"].view(np.uint8), axis=1, bitorder="little")
    f = (a_q * (b["query_weights"] * unc)).sum(1, dtype=np.float64).astype(np.float32)
    g = np.unpackbits((b["clause_doc_bits"] & ~b["covered_d"]).view(np.uint8), axis=1,
                      bitorder="little").sum(1).astype(np.float32)
    return {"fbar": f, "flow": f.copy(), "gbar": g[:, None], "glow": g[:, None].copy()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else np.array(v))
            for k, v in b.items()}


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def np32(t) -> np.ndarray:
    a = np.asarray(t)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# -- the port's rounds ---------------------------------------------------------------

def port_dense(b, mesh=None):
    fn = T.solve_fn("solve_dense_m")
    if mesh is None:
        return [np32(x) for x in fn(to_torch(b))]
    with D.use_mesh(mesh):
        return [np32(x) for x in fn(to_torch(b))]


def port_optpes(b, mesh=None):
    fn = T.solve_fn("solve_optpes_l")
    batch = to_torch({**b, **optpes_bounds(b)})
    if mesh is None:
        rs, did, anyf, j = fn(batch)
    else:
        with D.use_mesh(mesh):
            rs, did, anyf, j = fn(batch)
    return [np32(x) for x in (rs.covered_q, rs.covered_d, rs.selected, rs.g_part, rs.fbar,
                              rs.flow, rs.gbar, rs.glow, rs.f_val)] + [did, anyf, j]


def port_sparse(b, mesh=None):
    fn = T.solve_fn("solve_sparse_xl")
    if mesh is None:
        return [np32(x) for x in fn(to_torch(b))]
    with D.use_mesh(mesh):
        return [np32(x) for x in fn(to_torch(b))]


PORT = {"dense": port_dense, "optpes": port_optpes, "sparse": port_sparse}


def same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w), (i, g, w)


# -- the reference's direct rounds (one device, in process) -------------------------------

def ref_dense(b):
    from repro.configs import tiering_scsk as RT
    out = RT.solve_fn("solve_dense_m")({k: v for k, v in to_jax(b).items()
                                         if k != "clause_doc_ids"})
    return [np32(x) for x in out]


def ref_optpes(b):
    from repro.configs import tiering_scsk as RT
    batch = to_jax({**{k: v for k, v in b.items() if k != "clause_doc_ids"},
                    **optpes_bounds(b)})
    state, did, anyf, j = RT.solve_fn("solve_optpes_l")(batch)
    return [np32(x) for x in state] + [int(did), int(anyf), int(j)]


def ref_sparse(b):
    from repro.configs import tiering_scsk as RT
    out = RT.solve_fn("solve_sparse_xl")({k: v for k, v in to_jax(b).items()
                                           if k != "clause_doc_bits"})
    return [np32(x) for x in out[:4]] + [int(out[4]), bool(out[5])]


def port_as_ref(kind, got):
    """The port's outputs in the reference's layout: optpes' g_part is the
    reference's [1] g_used; the sparse round's j and stop are host values."""
    if kind == "optpes":
        return got[:9] + [int(got[9]), int(got[10]), int(got[11])]
    return got


# -- the plan helpers -----------------------------------------------------------------------

def test_plan_roles_and_gate():
    from repro.distributed import plan as jplan
    plan, want = D.current_plan(), jplan.current_plan()
    assert plan.model_axis is None is want.model_axis and not plan.model_fused
    assert plan.data_axes == want.data_axes == ("data",) and not want.model_fused
    with D.use_mesh(mesh_of((2, 2))):
        plan = D.current_plan()
        assert plan.model_axis == "model" and plan.model_fused
        assert plan.data_axes == ("data",) and plan.shard_axis is None
        assert D.mesh_fused(lambda devs, x: (len(devs), x), axis="model")(3) == (4, 3)
        assert D.mesh_fused(lambda devs: devs) is None            # no "shard" axis
    with D.use_mesh(D.Mesh("model", (CPU,))):
        assert not D.current_plan().model_fused
        assert D.mesh_fused(lambda devs: devs, axis="model") is None
    m = D.Mesh(("pod", "data", "model"), (CPU,) * 8, (2, 2, 2))
    assert [D.axis_rank(m, ("pod", "data"), e) for e in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [D.axis_rank(m, ("model",), e) for e in range(8)] == [0, 1] * 4
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1}


def test_owner_select_matches_the_reference_semantics():
    from repro.distributed import plan as jplan
    rng = np.random.default_rng(3)
    a = rng.integers(-5, 5, (6, 3)).astype(np.int32)
    idx = np.array([0, 5, 6, 11, 17, 7], np.int32)
    for rank in range(3):
        for fill in (0, -1):
            want = np.asarray(jplan.owner_select(jnp.asarray(a), jnp.asarray(idx),
                                                 jnp.int32(rank), fill=fill))
            got = D.owner_select(torch.from_numpy(a), torch.from_numpy(idx), rank, fill=fill)
            np.testing.assert_array_equal(got.numpy(), want)
            want1 = np.asarray(jplan.owner_select(jnp.asarray(a), jnp.int32(8),
                                                  jnp.int32(rank), fill=fill))
            got1 = D.owner_select(torch.from_numpy(a), torch.tensor(8), rank, fill=fill)
            np.testing.assert_array_equal(got1.numpy(), want1)


@pytest.mark.parametrize("dims", MESHES)
def test_place_cuts_blocks_once(dims):
    b = to_torch(make_batch())
    mat = b["clause_query_bits"]
    mesh = mesh_of(dims)
    spec = D.sharding.P(("data",), "model")
    placed = D.place(mat, spec, mesh)
    assert D.place(mat, spec, mesh) is placed               # placed once, kept
    for e, blk in enumerate(placed.blocks):
        rs, cs = D.sharding.block_slices(tuple(mat.shape), spec, mesh, e)
        assert torch.equal(blk, mat[rs, cs]) and blk.is_contiguous()
        assert D.sharding.entry_shape(tuple(mat.shape), spec, mesh, e) == tuple(blk.shape)
    assert sum(x.numel() for x in placed.blocks) == mat.numel()


@pytest.mark.parametrize("dims", MESHES)
def test_owner_row_equals_the_row(dims):
    b = to_torch(make_batch())
    with D.use_mesh(mesh_of(dims)):
        for j in (0, 63, 64, 130, C - 1):
            for name, kw in (("clause_query_bits", dict(w_axis="model")),
                             ("clause_doc_bits", dict(w_axis="model")),
                             ("clause_doc_ids", dict(ids=True))):
                got = D.owner_row(b[name], torch.tensor(j), **kw)
                assert torch.equal(got, b[name][j]), (name, j)
                assert torch.equal(D.owner_row(b[name], j, **kw), b[name][j])


@pytest.mark.parametrize("dims", MESHES)
def test_model_gains_equal_the_direct_kernels(dims):
    from repro_torch.core import bitset
    from repro_torch.kernels import ops
    b = to_torch(make_batch())
    x = (b["query_weights"] * (1.0 - bitset.unpack(b["covered_q"]).float()))[:, None]
    fg = ops.bit_matvec(b["clause_query_bits"], x)[:, 0]
    gg = ops.coverage_gain(b["clause_doc_bits"], b["covered_d"]).float()
    idx = torch.tensor([5, 200, 64, 255, 0, 127], dtype=torch.int64)
    with D.use_mesh(mesh_of(dims)):
        f1, g1 = D.model_gains(b["clause_query_bits"], x, b["clause_doc_bits"], b["covered_d"])
        f2, g2 = D.model_gains(b["clause_query_bits"], x, b["clause_doc_bits"], b["covered_d"],
                               idx)
        f3, g3 = D.model_gains(b["clause_query_bits"], x)
    assert torch.equal(f1, fg) and torch.equal(g1, gg) and torch.equal(f3, fg) and g3 is None
    assert torch.equal(f2, fg[idx]) and torch.equal(g2, gg[idx])


# -- the rounds on the meshes against the port's and the reference's direct paths ----------

@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("kind", ["dense", "optpes", "sparse"])
def test_round_on_mesh_equals_direct_paths(kind, dims):
    b = make_batch()
    direct = PORT[kind](b)
    got = PORT[kind](b, mesh_of(dims))
    same(got, direct)
    want = {"dense": lambda: ref_dense(b), "sparse": lambda: ref_sparse(b),
            "optpes": lambda: ref_optpes(b)}[kind]()
    same(port_as_ref(kind, got), want)


def test_sparse_round_fuses_only_without_data_ranks(monkeypatch):
    """The sparse round fuses where the data axes are of size 1 and takes
    the direct path elsewhere (the reference raises there)."""
    calls = []
    real = D.model_gains
    monkeypatch.setattr(D, "model_gains", lambda *a, **k: calls.append(1) or real(*a, **k))
    b = make_batch()
    for dims, fused in (((1, 4), True), ((2, 2), False), ((4, 1), False)):
        calls.clear()
        port_sparse(b, mesh_of(dims))
        assert bool(calls) == fused, dims
    calls.clear()
    port_sparse(b, D.Mesh("model", (CPU,) * 4))
    assert calls


def test_optpes_solver_on_mesh_equals_direct():
    """The whole Opt/Pes solve through the registry under a (2, 2) mesh:
    the same order, f and g as direct."""
    from repro_torch.core.config import SolveConfig
    b = to_torch(make_batch(1))
    w = b["query_weights"]
    prob = SCSKProblem(clause_query_bits=b["clause_query_bits"],
                       clause_doc_bits=b["clause_doc_bits"], query_weights=w,
                       test_weights=w, n_queries=NQ, n_docs=ND)
    cfg = SolveConfig(budget=1500.0, solver="optpes", max_steps=12, options={"k": K})
    direct = topt.solve_optpes(prob, cfg)
    with D.use_mesh(mesh_of((2, 2))):
        fused = topt.solve_optpes(prob, cfg)
    assert fused.order == direct.order and len(direct.order) >= 8
    assert fused.f_final == direct.f_final and fused.g_final == direct.g_final
    assert torch.equal(fused.state.covered_d, direct.state.covered_d)


def test_partitioned_constraint_takes_the_direct_path(monkeypatch):
    calls = []
    real = D.model_gains
    monkeypatch.setattr(D, "model_gains", lambda *a, **k: calls.append(1) or real(*a, **k))
    from repro_torch.core.constraint import PartitionedBudget, partition_bounds
    b = to_torch(make_batch(2))
    w = b["query_weights"]
    prob = SCSKProblem(clause_query_bits=b["clause_query_bits"],
                       clause_doc_bits=b["clause_doc_bits"], query_weights=w,
                       test_weights=w, n_queries=NQ, n_docs=ND)
    bounds = partition_bounds(ND, 2)
    cons = PartitionedBudget(bounds=bounds, caps=np.array([200.0, 200.0]))
    idx = torch.arange(8)
    with D.use_mesh(mesh_of((2, 2))):
        fg, gg = topt._subset_gains(prob, cons, b["covered_q"], b["covered_d"], idx)
    assert not calls and gg.shape == (8, 2)
    f0, g0 = topt._subset_gains(prob, cons, b["covered_q"], b["covered_d"], idx)
    assert torch.equal(fg, f0) and torch.equal(gg, g0)


# -- against the reference's fused path on four XLA host devices ---------------------------

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np, jax.numpy as jnp
from repro.distributed import mesh_context
from repro.configs import tiering_scsk as RT
assert len(jax.devices()) == 4
b = dict(np.load(sys.argv[1]))
k = int(sys.argv[3])
RT.CONFIG = RT.TieringScaleConfig(refresh_k=k)
out = {}
def u(x):
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a
for dims in [(1, 4), (2, 2), (4, 1)]:
    mesh = jax.make_mesh(dims, ("data", "model"))
    with mesh, mesh_context.use_mesh(mesh):
        dense = RT.solve_fn("solve_dense_m")({k_: jnp.asarray(v) for k_, v in b.items()
                                              if k_ not in ("clause_doc_ids", "fbar", "flow", "gbar", "glow")})
        for i, x in enumerate(dense):
            out[f"dense_{dims[0]}x{dims[1]}_{i}"] = u(x)
        state, did, anyf, j = RT.solve_fn("solve_optpes_l")({k_: jnp.asarray(v) for k_, v in b.items()
                                                           if k_ != "clause_doc_ids"})
        for i, x in enumerate(list(state) + [did, anyf, j]):
            out[f"optpes_{dims[0]}x{dims[1]}_{i}"] = u(x)
        if dims == (1, 4):
            sp = RT.solve_fn("solve_sparse_xl")({k_: jnp.asarray(v) for k_, v in b.items()
                                                 if k_ not in ("clause_doc_bits", "fbar", "flow", "gbar", "glow")})
            for i, x in enumerate(sp):
                out[f"sparse_{dims[0]}x{dims[1]}_{i}"] = u(x)
np.savez(sys.argv[2], **out)
print("reference fused OK", len(out))
"""


@pytest.fixture(scope="module")
def reference_fused(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_axis")
    b = make_batch()
    np.savez(d / "in.npz", **b, **optpes_bounds(b))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
                          str(K)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return b, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", ["dense-1x4", "dense-2x2", "dense-4x1", "optpes-1x4",
                                  "optpes-2x2", "optpes-4x1", "sparse-1x4"])
def test_mesh_equals_reference_fused_path(reference_fused, case):
    b, out = reference_fused
    kind, dims = case.split("-")
    shape = tuple(int(x) for x in dims.split("x"))
    got = port_as_ref(kind, PORT[kind](b, mesh_of(shape)))
    n = len([k for k in out if k.startswith(f"{kind}_{dims}_")])
    want = [out[f"{kind}_{dims}_{i}"] for i in range(n)]
    if kind == "sparse":
        want = want[:4] + [int(want[4]), bool(want[5])]
    elif kind == "optpes":
        want = want[:9] + [int(want[9]), int(want[10]), int(want[11])]
    same(got, want)
