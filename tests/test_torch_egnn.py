"""The port's EGNN (`repro_torch.models.egnn`), its neighbour sampler
(`models/sampler.py`), its config and registry glue, `data_axes` and
`quantized_psum`, against the reference's (`repro.models.egnn`,
`repro.models.sampler`, `repro.configs.egnn`).

The reference's `init_params(jax.random.key(0))` parameters are carried over
by `convert.egnn_params_from_numpy`, the batches come from numpy seeds. f32
on the CPU (the segment sums on the plain version `ref.segment_sum`):
forward and serve outputs within rtol 1e-4 + atol 1e-4 x max|ref|, the loss
within 1e-5, every gradient leaf within 1e-3 x max|g| + 1e-6. The edge
"data" mesh runs on 2 and 4 CPU entries against the direct path at the
reference's own limit (rtol 1e-4, atol 1e-5, `tests/test_multidevice.py`).
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import egnn as JG
from repro.models import sampler as JS
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.distributed import Mesh, data_axes, use_mesh
from repro_torch.distributed.compression import quantized_psum
from repro_torch.models import egnn as TG
from repro_torch.models import sampler as TS
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import make_train_step

OUT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3


def _cfgs(**kw):
    jcfg = JG.EGNNConfig(**kw)
    return jcfg, TG.EGNNConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, tcfg, seed=0):
    jp = JG.init_params(jax.random.key(seed), jcfg)
    return jp, convert.egnn_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _batch(n, e, d, c=3, pad=0, graphs=0, seed=0):
    rng = np.random.default_rng(seed)
    b = {"node_feat": rng.standard_normal((n, d)).astype(np.float32),
         "coords": rng.standard_normal((n, 3)).astype(np.float32),
         "edges": rng.integers(0, n, (2, e)).astype(np.int32)}
    if pad:
        b["edges"][:, -pad:] = -1
        b["edges"][0, 3] = -1           # one edge with only its src missing
    if graphs:
        b["graph_ids"] = np.repeat(np.arange(graphs), n // graphs).astype(np.int32)
        b["targets"] = rng.standard_normal(graphs).astype(np.float32)
    else:
        labels = rng.integers(0, c, n).astype(np.int32)
        labels[::5] = -100
        b["labels"] = labels
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v)
                                                      for k, v in b.items()}


def _close(got, want, tol=OUT_TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1e-30, float(np.abs(want).max())))


# (name, config kwargs, batch kwargs, the port's edge chunk)
CASES = [
    ("node_class", dict(n_layers=2, d_hidden=16, d_feat=8, n_classes=3),
     dict(n=24, e=64, d=8), None),
    ("node_class_padded", dict(n_layers=2, d_hidden=8, d_feat=5, n_classes=4),
     dict(n=40, e=160, d=5, c=4, pad=16), None),
    ("node_class_chunked", dict(n_layers=2, d_hidden=8, d_feat=5, n_classes=4),
     dict(n=30, e=150, d=5, c=4, pad=7), 40),
    ("graph_reg", dict(n_layers=2, d_hidden=16, d_feat=6, n_classes=1, task="graph_reg"),
     dict(n=48, e=120, d=6, graphs=4), None),
]


_REF: dict = {}


def _case(name):
    """(port cfg, port params, port batch, the reference's (loss, metrics),
    gradients, forward and serve outputs) of a CASES row, the reference
    jitted once."""
    if name not in _REF:
        _, ckw, bkw, chunk = next(c for c in CASES if c[0] == name)
        jcfg, tcfg = _cfgs(**ckw)
        if chunk:
            tcfg = dataclasses.replace(tcfg, edge_chunk=chunk)
        jp, tp = _params(jcfg, tcfg)
        jb, tb = _batch(**bkw)

        def ref(p, b):
            return (jax.value_and_grad(lambda q: JG.loss_fn(q, b, jcfg), has_aux=True)(p),
                    JG.forward(p, b, jcfg), JG.serve_step(p, b, jcfg))
        _REF[name] = (tcfg, tp, tb, *jax.jit(ref)(jp, jb))
    return _REF[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_loss_and_grads_match_reference(name):
    tcfg, tp, tb, ((jl, jm), jg), _, _ = _case(name)
    tp = tree.map(lambda a: a.detach().clone().requires_grad_(True), tp)
    leaves = tree.leaves(tp)
    tl, tm = TG.loss_fn(tp, tb, tcfg)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=LOSS_TOL)
    for (path, _), got, want in zip(tree.leaves_with_paths(tp), grads, jax.tree.leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max() + 1e-6, err_msg=path)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_forward_and_serve_match_reference(name):
    tcfg, tp, tb, _, (jh, jx), (jlog, jx2) = _case(name)
    with torch.no_grad():
        th, tx = TG.forward(tp, tb, tcfg)
        tlog, tx2 = TG.serve_step(tp, tb, tcfg)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == tuple(jlog.shape)
    for got, want in ((th, jh), (tx, jx), (tlog, jlog), (tx2, jx2)):
        _close(got.numpy(), want)


def test_chunks_continue_the_sums():
    """Edge chunks continue each node's sums through out0: one chunk is the
    unchunked layer bit for bit, and more chunks add the same rows in the
    same order (the segment-sum tests hold that bit for bit); only the MLP
    rows, computed in GEMMs of another height, may round otherwise."""
    _, tcfg = _cfgs(n_layers=3, d_hidden=8, d_feat=5, n_classes=4)
    _, tb = _batch(n=50, e=300, d=5, c=4, pad=9, seed=4)
    params = TG.init_params(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        h1, x1 = TG.forward(params, tb, tcfg)
        h2, x2 = TG.forward(params, tb, dataclasses.replace(tcfg, edge_chunk=300))
        assert torch.equal(h1, h2) and torch.equal(x1, x2)
        for chunk in (7, 64, 299):
            cfg = dataclasses.replace(tcfg, edge_chunk=chunk)
            assert sum(len(c) for _, c in TG.edge_plan(tb["edges"], 50, cfg).entries) \
                == -(-300 // chunk)
            h2, x2 = TG.forward(params, tb, cfg)
            _close(h2.numpy(), h1.numpy(), 1e-5)
            _close(x2.numpy(), x1.numpy(), 1e-5)


@pytest.mark.parametrize("chunk,entries", [(1 << 22, 1), (7, 1), (64, 1), (13, 2)])
def test_edge_plan_lays_the_edges_out_by_destination(chunk, entries):
    """Each entry's block of edges stably sorted by dst, invalid edges last,
    then cut into chunks: the dst plans are sorted plans over contiguous,
    ordered node ranges, the src plans permuted plans of the same rows, and
    each node's incoming edges keep ascending original edge order."""
    _, tcfg = _cfgs(n_layers=2, d_hidden=8, d_feat=5, n_classes=4)
    cfg = dataclasses.replace(tcfg, edge_chunk=chunk)
    _, tb = _batch(n=50, e=300, d=5, c=4, pad=9, seed=4)
    edges = tb["edges"]
    mesh = Mesh("data", (torch.device("cpu"),) * entries) if entries > 1 else None
    if mesh is None:
        plan = TG.edge_plan(edges, 50, cfg)
    else:
        with use_mesh(mesh):
            plan = TG.edge_plan(edges, 50, cfg)
    assert len(plan.entries) == entries
    step = 300 // entries
    deg = torch.zeros(50, dtype=torch.int64)
    for r, (_, chunks) in enumerate(plan.entries):
        blk = edges[:, r * step:(r + 1) * step]
        valid = (blk[0] >= 0) & (blk[1] >= 0)
        ids = np.arange(r * step, (r + 1) * step)[valid.numpy()]
        want_ids = ids[np.argsort(blk[1].numpy()[valid.numpy()], kind="stable")]
        assert len(chunks) == -(-step // chunk)
        got_dst, got_src, prev_hi = [], [], 0
        for ch in chunks:
            assert ch.dst.perm is None and ch.src.perm is not None
            m = int(ch.dst.counts().sum())
            assert ch.src.perm.shape[0] == m
            idx = ch.dst.index[:m]
            assert torch.all(idx[1:] >= idx[:-1])
            lo, hi = ch.dst.bounds.tolist()
            if m:
                assert (lo, hi) == (int(idx[0]), int(idx[-1]) + 1) and lo >= prev_hi - 1
                prev_hi = hi
            got_dst.append(idx)
            got_src.append(ch.src.index[:m])
            deg += ch.dst.counts().long()
        # the rows, in order, are the valid edges sorted stably by dst
        assert torch.equal(torch.cat(got_dst), blk[1].new_tensor(edges[1].numpy()[want_ids]))
        assert torch.equal(torch.cat(got_src), blk[0].new_tensor(edges[0].numpy()[want_ids]))
        for node in np.unique(edges[1].numpy()[want_ids]):
            mine = want_ids[edges[1].numpy()[want_ids] == node]
            assert np.all(np.diff(mine) > 0)
    valid = (edges[0] >= 0) & (edges[1] >= 0)
    want_deg = torch.bincount(edges[1][valid].long(), minlength=50)
    assert torch.equal(deg, want_deg) and torch.equal(plan.deg, want_deg.float())


def test_node_sums_keep_ascending_edge_order():
    """Messages whose sum depends on its order ((1e8 + 1) - 1e8 + 1 = 1 in
    f32, other orders give 0 or 2): summed through the chunks' dst plans in
    place, each node gets the sum in ascending original edge order, as an
    unchunked sequential index_add_ does, bit for bit."""
    n, e = 6, 48
    rng = np.random.default_rng(3)
    dst = rng.integers(0, n, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    vals = np.tile(np.array([1e8, 1.0, -1e8, 1.0], np.float32), e // 4)[:, None]
    edges = torch.from_numpy(np.stack([src, dst]))
    want = torch.zeros((n, 1)).index_add_(0, torch.from_numpy(dst).long(),
                                           torch.from_numpy(vals))
    for chunk in (5, 16, 48):
        _, cfg = _cfgs(n_layers=1, d_hidden=4, d_feat=2, n_classes=2)
        plan = TG.edge_plan(edges, n, dataclasses.replace(cfg, edge_chunk=chunk))
        order = np.argsort(dst, kind="stable")
        rows = torch.from_numpy(vals[order])
        acc = None
        for i, ch in enumerate(plan.entries[0][1]):
            acc = TG.S.sum_rows(rows[i * chunk:(i + 1) * chunk], ch.dst, acc, inplace=True)
        assert torch.equal(acc.view(torch.int32), want.view(torch.int32))


def test_equivariance():
    """Mirrors the reference's test_egnn_equivariance with the port's own
    initial weights (3 layers, d_hidden 16, 30 nodes, 90 edges)."""
    cfg = TG.EGNNConfig(n_layers=3, d_hidden=16, d_feat=8, n_classes=4)
    params = TG.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"node_feat": torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32)),
             "coords": torch.from_numpy(rng.standard_normal((30, 3)).astype(np.float32)),
             "edges": torch.from_numpy(rng.integers(0, 30, (2, 90)).astype(np.int32))}
    theta = 1.1
    q = torch.tensor([[np.cos(theta), -np.sin(theta), 0],
                      [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], dtype=torch.float32)
    with torch.no_grad():
        h1, x1 = TG.forward(params, batch, cfg)
        h2, x2 = TG.forward(params, dict(batch, coords=batch["coords"] @ q.T + 7.0), cfg)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose((x1 @ q.T + 7.0).numpy(), x2.numpy(), rtol=2e-3, atol=1e-2)


# -- the sampler ---------------------------------------------------------------

def test_neighbor_sampler():
    """Mirrors the reference's test_neighbor_sampler."""
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 100, (2, 600)).astype(np.int64)
    g = TS.CSRGraph.from_edges(edges, 100)
    seeds = np.array([3, 14, 15])
    nodes, sub_edges, seed_mask = TS.sample_subgraph(
        g, seeds, (5, 3), rng, pad_nodes=80, pad_edges=120)
    assert nodes.shape == (80,) and sub_edges.shape == (2, 120)
    real = nodes[nodes >= 0]
    assert set(seeds) <= set(real.tolist())
    emap = set(zip(edges[0].tolist(), edges[1].tolist()))
    for s, d in zip(*sub_edges):
        if s < 0:
            continue
        assert (real[d], real[s]) in emap
    assert seed_mask[:len(real)].sum() == len(seeds)


def test_sampler_respects_fanout():
    rng = np.random.default_rng(1)
    edges = np.stack([np.zeros(50, np.int64), np.arange(50, dtype=np.int64)])
    g = TS.CSRGraph.from_edges(edges, 51)
    _, sub_edges, _ = TS.sample_subgraph(g, np.array([0]), (7,), rng)
    assert (sub_edges[0] >= 0).sum() == 7


@pytest.mark.parametrize("seed,fanouts,pads", [(0, (5, 3), (120, 200)), (7, (15, 10), None),
                                               (3, (2, 2, 2), (200, 300))])
def test_sampler_equals_reference(seed, fanouts, pads):
    """The same Generator seed gives the reference's arrays exactly."""
    rng = np.random.default_rng(100 + seed)
    edges = rng.integers(0, 150, (2, 900)).astype(np.int64)
    seeds = rng.choice(150, 6, replace=False)
    kw = {} if pads is None else dict(pad_nodes=pads[0], pad_edges=pads[1])
    jg, tg = JS.CSRGraph.from_edges(edges, 150), TS.CSRGraph.from_edges(edges, 150)
    np.testing.assert_array_equal(jg.indptr, tg.indptr)
    np.testing.assert_array_equal(jg.indices, tg.indices)
    want = JS.sample_subgraph(jg, seeds, fanouts, np.random.default_rng(seed), **kw)
    got = TS.sample_subgraph(tg, seeds, fanouts, np.random.default_rng(seed), **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- the data mesh, data_axes, quantized_psum ------------------------------------

@pytest.mark.parametrize("entries", [2, 4])
def test_data_mesh_equals_direct(entries):
    """Edges split over the entries of a "data" mesh of CPU entries, their
    sums added on the first: equal to the direct path at the reference's
    limit (its EGNN edge-sharding check)."""
    _, tcfg = _cfgs(n_layers=2, d_hidden=8, d_feat=4, n_classes=2)
    params = TG.init_params(torch.Generator().manual_seed(5), tcfg)
    _, tb = _batch(n=20, e=64, d=4, c=2, pad=4, seed=6)
    with torch.no_grad():
        h, x = TG.forward(params, tb, tcfg)
        with use_mesh(Mesh("data", (torch.device("cpu"),) * entries)):
            plan = TG.edge_plan(tb["edges"], 20, tcfg)
            hm, xm = TG.forward(params, tb, tcfg)
    assert len(plan.entries) == entries
    np.testing.assert_allclose(hm.numpy(), h.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xm.numpy(), x.numpy(), rtol=1e-4, atol=1e-5)


def test_other_meshes_take_the_direct_path():
    _, tcfg = _cfgs(n_layers=2, d_hidden=8, d_feat=4, n_classes=2)
    params = TG.init_params(torch.Generator().manual_seed(5), tcfg)
    _, tb = _batch(n=20, e=63, d=4, c=2, seed=6)
    cpu = torch.device("cpu")
    with torch.no_grad():
        h, _ = TG.forward(params, tb, tcfg)
        for mesh in (Mesh("model", (cpu,) * 4), Mesh("data", (cpu,) * 2), Mesh("data", (cpu,))):
            with use_mesh(mesh):
                assert len(TG.edge_plan(tb["edges"], 20, tcfg).entries) == 1
                assert torch.equal(TG.forward(params, tb, tcfg)[0], h)


def test_data_axes():
    cpu = torch.device("cpu")
    assert data_axes() == ("data",)
    assert data_axes(Mesh("model", (cpu,) * 2)) == ()
    assert data_axes(Mesh("shard", (cpu,) * 2)) == ("shard",)
    with use_mesh(Mesh("model", (cpu,))):
        assert data_axes() == ()


def _qpsum_numpy(v):
    """The reference's quantized_psum, restated in numpy over the rows of v."""
    scale = np.max([np.float32(np.max(np.abs(x))) / np.float32(127.0) + np.float32(1e-12)
                    for x in v]).astype(np.float32)
    q = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    return q.astype(np.int32).sum(0).astype(np.float32) * scale


@pytest.mark.parametrize("entries,shape", [(8, (32,)), (3, (5, 7)), (2, (1,))])
def test_quantized_psum(entries, shape):
    v = np.random.default_rng(entries).standard_normal((entries, *shape)).astype(np.float32)
    parts = [torch.from_numpy(x) for x in v]
    got = quantized_psum(parts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _qpsum_numpy(v))
    err = np.abs(got.numpy() - v.sum(0)).max()
    assert err < entries * 2 * np.abs(v).max() / 127


# -- config, registry, training ----------------------------------------------------

def test_config_registry_and_cells():
    ja, ta = jregistry.get_arch("egnn"), tregistry.get_arch("egnn")
    assert (ta.family, ta.shapes, ta.optimizer) == (ja.family, ja.shapes, ja.optimizer) \
        == ("gnn", tregistry.GNN_SHAPES, "adamw")
    assert tregistry.GNN_DIMS == jregistry.GNN_DIMS
    jcfg, jbatch, jkind = ja.smoke()
    tcfg, tbatch, tkind = ta.smoke()
    assert jkind == tkind == "train"
    assert TG.EGNNConfig(**dataclasses.asdict(jcfg)) == tcfg
    assert set(jbatch) == set(tbatch)
    for k in jbatch:
        want = np.array(jbatch[k])
        assert tbatch[k].numpy().dtype == want.dtype
        np.testing.assert_array_equal(tbatch[k].numpy(), want)
    mesh = jax.make_mesh((1,), ("data",))
    for shape in ja.shapes:
        assert TG.EGNNConfig(**dataclasses.asdict(ja.config_for(shape))) == ta.config_for(shape)
        jcell, tcell = ja.cell_for(shape, mesh), ta.cell_for(shape)
        assert tcell.kind == jcell.kind
        assert tcell.dims == {k: tuple(v.shape) for k, v in jcell.inputs.items()}


def test_smoke_arch_trains_and_moves_its_parameters():
    """The registry's SMOKE arch, 3 AdamW steps (as test_arch_smoke): finite
    losses, and every parameter the loss reaches moves (the last layer's
    phi_x feeds only the coordinates, which no loss reads: its gradient is
    zero here as in the reference, and its zero biases stay)."""
    arch = tregistry.get_arch("egnn")
    cfg, batch, _ = arch.smoke()
    params = TG.init_params(torch.Generator().manual_seed(0), cfg)
    before = [p.clone() for p in tree.leaves(params)]
    init_state, train_step = make_train_step(
        arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer, lr=1e-3, warmup_steps=1))
    state = init_state(params)
    losses = []
    for _ in range(3):
        state, met = train_step(state, batch)
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and int(state["step"]) == 3
    last = f"layers/{cfg.n_layers - 1}/phi_x/"
    for (path, p), p0 in zip(tree.leaves_with_paths(state["params"]), before):
        if path.startswith(last) and path.endswith("/b"):
            assert torch.equal(p, p0), path
        else:
            assert not torch.equal(p, p0), path


def test_convert_keeps_the_tree():
    jcfg, tcfg = _cfgs(n_layers=2, d_hidden=4, d_feat=3, n_classes=2)
    jp, tp = _params(jcfg, tcfg)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    assert len(paths) == len(jax.tree.leaves(jp)) == 2 + 2 * 12 + 4
    assert isinstance(tp["layers"], list) and isinstance(tp["layers"][0]["phi_e"], list)
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    """launch.train --arch egnn and the example twin take the card when no
    --device is given: without one they raise, never falling back."""
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run(launch.parse_args(["--arch", "egnn", "--steps", "1"]))
    path = Path(__file__).resolve().parents[1] / "examples" / "egnn_molecule_torch.py"
    spec = importlib.util.spec_from_file_location("egnn_molecule_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["egnn_molecule_torch.py"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()
