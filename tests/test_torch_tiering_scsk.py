"""The port's tiering-scsk arch (`configs/tiering_scsk.py`): its cells'
dims and specs against the reference's `cell_for(shape, mesh)`, its smoke
batch, and all five shapes' `solve_fn` at small sizes against the
reference's, on the same numpy inputs; the registry and `launch.train`'s
refusal."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.configs import tiering_scsk as T
from repro_torch.launch import mesh as tmesh

SHAPES = ["solve_dense_m", "solve_dense_l", "solve_optpes_l", "solve_sparse_xl", "serve_route"]


def stand_in(multi: bool):
    """What the reference's cells read of a mesh: axis names and sizes."""
    if multi:
        return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     shape={"pod": 2, "data": 16, "model": 16})
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16})


def norm_spec(spec) -> tuple:
    parts = [tuple(p) if isinstance(p, (tuple, list)) and len(p) > 1
             else (p[0] if isinstance(p, (tuple, list)) and len(p) == 1 else p)
             for p in spec]
    parts = [None if p == () else p for p in parts]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


DTYPES = {"uint32": torch.int32, "int32": torch.int32, "float32": torch.float32,
          "bool": torch.bool}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_cells_equal_the_reference(shape, multi):
    from repro.configs import tiering_scsk as RT
    want = RT._cell(shape, stand_in(multi))
    got_in, got_specs = T.abstract_cell(shape, tmesh.make_production_mesh(multi_pod=multi))
    assert want.kind == T._cell(shape).kind == "solve"
    assert set(got_in) == set(want.inputs) == set(T._cell(shape).dims)
    for name, sds in want.inputs.items():
        assert tuple(got_in[name].shape) == tuple(sds.shape) == tuple(T._cell(shape).dims[name])
        assert got_in[name].dtype == DTYPES[str(sds.dtype)] and got_in[name].is_meta
        assert norm_spec(got_specs[name]) == norm_spec(want.input_specs[name]), name


def test_config_and_registry():
    from repro.configs import tiering_scsk as RT
    assert T.SHAPES == RT.SHAPES and T.CONFIG.refresh_k == RT.CONFIG.refresh_k == 4096
    arch = R.get_arch("tiering-scsk")
    assert arch.family == "tiering" and arch.shapes == tuple(RT.SHAPES) and arch.loss_fn is None
    assert arch.abstract_params(T.CONFIG) == {} and arch.param_specs(T.CONFIG) == {}
    assert "tiering-scsk" in R.all_archs()


def test_smoke_batch_equals_the_reference():
    from repro.configs import tiering_scsk as RT
    cfg, batch, kind = T._smoke()
    rcfg, rbatch, rkind = RT._smoke()
    assert kind == rkind == "solve" and set(batch) == set(rbatch)
    for k, v in rbatch.items():
        want = np.asarray(v)
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(batch[k].numpy(), want)
    got = T.solve_fn("solve_dense_m")(dict(batch))
    ref = RT.solve_fn("solve_dense_m")(rbatch)
    for g, w in zip(got, ref):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.view(np.int32) if w.dtype == np.uint32 else w)


def test_train_launcher_refuses_the_arch():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="no loss"):
        train.main(["--arch", "tiering-scsk", "--device", "cpu"])


# -- every shape's solve_fn at a small size against the reference -------------------------

C, NQ, ND, M = 192, 512, 1024, 48


def words(rng, shape, p):
    bits = rng.random(shape + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def small_batch(shape: str, seed: int = 0) -> dict:
    """The cell's inputs at a small size (count weights over 2^10)."""
    rng = np.random.default_rng(seed)
    if shape == "serve_route":
        b, v, nd, k = 96, 256, 1024, 40
        toks = rng.integers(0, v, (b, 8)).astype(np.int32)
        toks[rng.random((b, 8)) < 0.4] = -1
        toks[:4] = -1                                           # empty queries
        cl = np.zeros((k, v // 32), np.uint32)
        for i in range(k):              # 2-token clauses from a query's own tokens
            q = toks[rng.integers(4, b)]
            for t in rng.choice(q[q >= 0], 2) if (q >= 0).sum() >= 2 else ():
                cl[i, t // 32] |= np.uint32(1 << (t % 32))
        cl = cl[cl.any(1)]
        return {"tokens": toks, "clause_vocab_bits": cl,
                "postings": words(rng, (v, nd // 32), 0.6),
                "tier1_mask": words(rng, (nd // 32,), 0.5)}
    out = {"clause_query_bits": words(rng, (C, NQ // 32), 0.05),
           "query_weights": (rng.integers(0, 16, NQ) / 1024).astype(np.float32),
           "covered_q": words(rng, (NQ // 32,), 0.1),
           "covered_d": words(rng, (ND // 32,), 0.1),
           "selected": rng.random(C) < 0.05,
           "g_used": np.float32(20.0), "budget": np.float32(ND // 4)}
    if shape == "solve_sparse_xl":
        ids = np.full((C, M), -1, np.int32)
        for c in range(C):
            n = rng.integers(1, M + 1)
            ids[c, :n] = np.sort(rng.choice(ND, n, replace=False))
        out["clause_doc_ids"] = ids
    else:
        out["clause_doc_bits"] = words(rng, (C, ND // 32), 0.03)
    if shape == "solve_optpes_l":
        unc = ~np.unpackbits(out["covered_q"].view(np.uint8), bitorder="little").astype(bool)
        a_q = np.unpackbits(out["clause_query_bits"].view(np.uint8), axis=1, bitorder="little")
        f = (a_q * (out["query_weights"] * unc)).sum(1, dtype=np.float64).astype(np.float32)
        g = np.unpackbits((out["clause_doc_bits"] & ~out["covered_d"]).view(np.uint8),
                          axis=1, bitorder="little").sum(1).astype(np.float32)
        out.update(fbar=f, flow=f.copy(), gbar=g[:, None], glow=g[:, None].copy())
    return out


def flat(x) -> list:
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in flat(v)]
    if hasattr(x, "covered_q"):                # the port's optpes RoundState
        return flat([x.covered_q, x.covered_d, x.selected, x.g_part, x.fbar, x.flow,
                     x.gbar, x.glow, x.f_val])
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return [a.view(np.int32) if a.dtype == np.uint32 else a]


@pytest.mark.parametrize("shape", SHAPES)
def test_solve_fn_equals_the_reference(shape, monkeypatch):
    from repro.configs import tiering_scsk as RT
    monkeypatch.setattr(RT, "CONFIG", RT.TieringScaleConfig(refresh_k=24))
    monkeypatch.setattr(T, "CONFIG", T.TieringScaleConfig(refresh_k=24))
    b = small_batch(shape)
    got = T.solve_fn(shape)(
        {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else np.array(v))
         for k, v in b.items()})
    want = RT.solve_fn(shape)({k: jnp.asarray(v) for k, v in b.items()})
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), (shape, i)
    if shape == "serve_route":
        assert 0 < want[1].sum() < len(want[1])        # both tiers served
