"""The port's recsys family (`repro_torch.models.recsys`, `embedding`,
`common.top_k`, the registry's recsys archs) against the reference's
(`repro.models.recsys`): each arch's SMOKE config, the reference's
`*_init(jax.random.key(0))` parameters carried across by
`convert.recsys_params_from_numpy`, and the same numpy-seeded batches.

f32 throughout: losses and serve outputs at rtol = atol = 1e-5, gradients
against `jax.value_and_grad` at rtol = atol = 1e-4; every top-k's ids
equal, in `jax.lax.top_k`'s tie order (values descending, the lower index
first at equal values, -inf included). The CPU runs the plain attention
(`ref.flash_attention`, non-causal) and its gradient
(`ref.flash_attention_bwd`). The row-sharded lookup and BERT4Rec's
`"model"`-mesh serve run on 4 CPU mesh entries against the direct path."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import embedding as jemb
from repro.models import recsys as J
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.distributed import Mesh, use_mesh
from repro_torch.models import common, embedding
from repro_torch.models import recsys as T
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import make_train_step

TOL = 1e-5
GRAD_TOL = 1e-4
ARCHS = ["deepfm", "bst", "bert4rec", "two-tower-retrieval"]
INIT = {"deepfm": (J.deepfm_init, T.deepfm_init), "bst": (J.bst_init, T.bst_init),
        "bert4rec": (J.bert4rec_init, T.bert4rec_init),
        "two-tower-retrieval": (J.twotower_init, T.twotower_init)}
CPU4 = Mesh("model", (torch.device("cpu"),) * 4)


def _tcfg(jcfg):
    """The port's config of the same name and fields as a reference config."""
    cls = {J.DeepFMConfig: T.DeepFMConfig, J.BSTConfig: T.BSTConfig,
           J.Bert4RecConfig: T.Bert4RecConfig, J.TwoTowerConfig: T.TwoTowerConfig}
    return cls[type(jcfg)](**dataclasses.asdict(jcfg))


_CACHE: dict = {}


def _arch(name):
    """(reference cfg, port cfg, reference params, port params, reference
    batch, port batch) of the arch's SMOKE config."""
    if name not in _CACHE:
        jcfg, jbatch, _ = jregistry.get_arch(name).smoke()
        tcfg, tbatch, _ = tregistry.get_arch(name).smoke()
        assert _tcfg(jcfg) == tcfg
        for k in jbatch:
            np.testing.assert_array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
        jp = INIT[name][0](jax.random.key(0), jcfg)
        tp = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _CACHE[name] = (jcfg, tcfg, jp, tp, jbatch, tbatch)
    return _CACHE[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves(jtree):
    return [np.asarray(x) for x in jax.tree.leaves(jtree)]


# -- training: loss and every gradient leaf ------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    jcfg, tcfg, jp, tp, jb, tb = _arch(name)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jregistry.get_arch(name).loss_fn(jcfg), has_aux=True))(jp, jb)
    tp = tree.map(lambda x: x.clone().requires_grad_(True), tp)
    tloss, tmet = tregistry.get_arch(name).loss_fn(tcfg)(tp, tb)
    grads = torch.autograd.grad(tloss, tree.leaves(tp))
    _close(tloss.detach(), jloss)
    assert set(tmet) == set(jmet)
    for k in jmet:
        _close(tmet[k].detach(), jmet[k])
    # the reference's leaves in jax.tree order == the port's sorted-key order
    jl = _leaves(jgrads)
    assert [p for p, _ in tree.leaves_with_paths(tp)] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for g, w in zip(grads, jl):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_arch_smoke_three_steps(name):
    """The reference's `test_arch_smoke` for the port: 3 AdamW steps through
    `make_train_step`, every loss finite, the parameters moved."""
    tarch = tregistry.get_arch(name)
    cfg, batch, kind = tarch.smoke()
    assert kind == "train" and tarch.family == "recsys" and tarch.optimizer == "adamw"
    init_state, train_step = make_train_step(
        tarch.loss_fn(cfg), OptimizerConfig(name=tarch.optimizer, lr=1e-3, warmup_steps=1))
    params = INIT[name][1](torch.Generator("cpu").manual_seed(0), cfg)
    before = [p.clone() for p in tree.leaves(params)]
    state = init_state(params)
    losses = []
    for _ in range(3):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(x) for x in losses), losses
    assert int(state["step"]) == 3
    assert any(not torch.equal(a, b) for a, b in zip(before, tree.leaves(state["params"])))


# -- serving --------------------------------------------------------------------

def _serve_batches(name, jcfg):
    """(serve batch, serve_candidates batch) as numpy. The candidate ids are
    distinct: a repeated candidate's score may differ by an ulp with its row
    in the batch (the CPU GEMM's blocking, ~3e-8 in BST), so ties are
    held on `top_k` itself, on BERT4Rec's -inf rows and on two-tower's
    repeated candidate rows (a matrix-vector product scores equal rows
    alike)."""
    rng = np.random.default_rng(7)
    i32 = np.int32
    if name == "deepfm":
        v, f = jcfg.vocab_per_field, jcfg.n_fields
        return ({"feat_ids": rng.integers(0, v, (12, f)).astype(i32)},
                {"user_feat_ids": rng.integers(0, v, (1, f - 1)).astype(i32),
                 "cand_ids": rng.permutation(v).astype(i32)})
    if name == "bst":
        n, s = jcfg.n_items, jcfg.seq_len
        hist = rng.integers(-1, n, (12, s)).astype(i32)
        return ({"hist": hist, "target": rng.integers(0, n, 12).astype(i32)},
                {"hist": hist[:1], "cand_ids": rng.permutation(n).astype(i32)})
    if name == "bert4rec":
        seq = rng.integers(0, jcfg.n_items, (6, jcfg.seq_len)).astype(i32)
        seq[:, -1] = jcfg.n_items
        return ({"seq": seq}, {"seq": seq[:1],
                               "cand_ids": rng.permutation(jcfg.n_items).astype(i32)})
    v, fu, fi = jcfg.vocab_per_field, jcfg.n_user_fields, jcfg.n_item_fields
    cand = rng.standard_normal((300, 16)).astype(np.float32)
    cand[200:] = cand[:100]
    return ({"user_ids": rng.integers(0, v, (12, fu)).astype(i32),
             "item_ids": rng.integers(0, v, (12, fi)).astype(i32)},
            {"user_ids": rng.integers(0, v, (1, fu)).astype(i32), "cand_emb": cand})


def _as_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _as_t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_serve_matches_the_reference(name):
    jcfg, tcfg, jp, tp, _, _ = _arch(name)
    jarch, tarch = jregistry.get_arch(name), tregistry.get_arch(name)
    serve, cand = _serve_batches(name, jcfg)
    want = jax.jit(jarch.serve_fn(jcfg, "serve_p99"))(jp, _as_j(serve))
    with torch.no_grad():
        got = tarch.serve_fn(tcfg, "serve_p99")(tp, _as_t(serve))
    if name == "bert4rec":      # (values, ids): the top 100 of 64 items, the rest -inf
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        _close(got, want)
    want = jax.jit(jarch.serve_fn(jcfg, "retrieval_cand"))(jp, _as_j(cand))
    with torch.no_grad():
        got = tarch.serve_fn(tcfg, "retrieval_cand")(tp, _as_t(cand))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bert4rec_serve_ranks_the_padding_rows_last_in_index_order():
    """k past the catalog: the mask token and padding rows score -inf and
    come after every item, lowest row first (the reference's order)."""
    jcfg, tcfg, jp, tp, _, _ = _arch("bert4rec")
    seq = np.random.default_rng(3).integers(0, 64, (3, jcfg.seq_len)).astype(np.int32)
    wv, wi = jax.jit(lambda p, s: J.bert4rec_serve(p, {"seq": s}, jcfg, k=80))(
        jp, jnp.asarray(seq))
    with torch.no_grad():
        gv, gi = T.bert4rec_serve(tp, {"seq": torch.from_numpy(seq)}, tcfg, k=80, chunk=2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gv, wv)
    assert (gi[:, 64:].numpy() == np.arange(64, 80)).all()


def test_tiered_serve_candidates_match_the_reference():
    jcfg, tcfg, jp, tp, _, _ = _arch("two-tower-retrieval")
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((120, 16)).astype(np.float32)
    ids = np.sort(rng.choice(1000, 120, replace=False)).astype(np.int32)
    b = {"user_ids": rng.integers(0, 50, (1, 3)).astype(np.int32), "tier1_emb": emb,
         "tier1_ids": ids}
    wv, wi = J.twotower_serve_candidates_tiered(jp, _as_j(b), jcfg)
    gv, gi = tregistry.get_arch("two-tower-retrieval").serve_fn(
        tcfg, "retrieval_cand_tiered")(tp, _as_t(b))
    _close(gv.detach(), wv)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_registry_cells_match_the_reference():
    """Every recsys cell's input shapes equal the reference's abstract
    inputs; the arch list, shapes, families and optimizers agree."""
    from repro.launch import mesh as mesh_lib
    mesh = mesh_lib.make_host_mesh()
    assert tregistry.RECSYS_BATCH == jregistry.RECSYS_BATCH
    assert tregistry.N_CANDIDATES == jregistry.N_CANDIDATES
    for name in ARCHS:
        ja, ta = jregistry.get_arch(name), tregistry.get_arch(name)
        assert (ta.family, ta.shapes, ta.optimizer) == (ja.family, ja.shapes, ja.optimizer)
        assert _tcfg(ja.config_for("train_batch")) == ta.config_for("train_batch")
        for shape in ja.shapes:
            jc, tc = ja.cell_for(shape, mesh), ta.cell_for(shape)
            assert tc.kind == jc.kind
            assert tc.dims == {k: tuple(v.shape) for k, v in jc.inputs.items()}


# -- components -----------------------------------------------------------------

def test_embedding_bag_vs_loop():
    """The reference's test_models.py case, on the port."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 50, (6, 5)).astype(np.int32))
    out = embedding.bag_lookup(table, idx)
    for b in range(6):
        want = sum((table[i].numpy() for i in idx[b].tolist() if i >= 0), np.zeros(8))
        np.testing.assert_allclose(out[b].numpy(), want, rtol=1e-6)
    mean = embedding.bag_lookup(table, idx, combiner="mean")
    want = jemb.bag_lookup(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()),
                           combiner="mean")
    _close(mean, want)


@pytest.mark.parametrize("seed", range(5))
def test_fm_identity(seed):
    """FM's ½((Σv)² − Σv²) == Σ_{i<j} <v_i, v_j>, as deepfm_logits forms it."""
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal((7, 4)))
    s = v.sum(dim=0)
    fast = 0.5 * (s * s - (v * v).sum(dim=0)).sum()
    slow = sum(v[i] @ v[j] for i in range(7) for j in range(i + 1, 7))
    np.testing.assert_allclose(float(fast), float(slow), rtol=1e-9)


def test_deepfm_fm_term_matches_pairwise():
    cfg = T.DeepFMConfig(n_fields=4, vocab_per_field=10, embed_dim=3, mlp_dims=(8,))
    params = T.deepfm_init(torch.Generator("cpu").manual_seed(0), cfg)
    ids = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    v = params["emb"][ids[0] + torch.arange(4) * 10].numpy()
    want = sum(v[i] @ v[j] for i in range(4) for j in range(i + 1, 4))
    p2 = dict(params, lin=torch.zeros_like(params["lin"]),
              mlp=[{"w": torch.zeros_like(x["w"]), "b": torch.zeros_like(x["b"])}
                   for x in params["mlp"]])
    np.testing.assert_allclose(float(T.deepfm_logits(p2, ids, cfg)[0]), want, rtol=1e-5)


@pytest.mark.parametrize("shape,k", [((40,), 10), ((3, 64), 64), ((5, 300), 17),
                                     ((2, 1000), 100)])
def test_top_k_order_is_jax_lax_top_k(shape, k):
    """Values drawn from a handful of levels (many ties), -inf, -0.0 and
    +0.0 among them: values and ids equal to jax.lax.top_k's."""
    rng = np.random.default_rng(sum(shape) + k)
    x = rng.integers(-4, 4, shape).astype(np.float32)
    x[x == -4] = -np.inf
    x[x == 3] = -0.0
    x[x == 2] = rng.standard_normal(int((x == 2).sum())).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = common.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.dtype == torch.int64


def test_sharded_lookup_equals_the_direct_path():
    """Rows split over 4 entries (each gathers its own, zeros elsewhere,
    summed on the first), values and gradients equal to the direct gather."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((64, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 64, (5, 7)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((5, 7, 6)).astype(np.float32))
    outs, grads = [], []
    for mesh in (None, CPU4):
        t = table.clone().requires_grad_(True)
        with use_mesh(mesh) if mesh else contextlib.nullcontext():
            rows = embedding.lookup(t, idx.clamp(min=0))
            bag = embedding.bag_lookup(t, idx)
        (rows * w).sum().backward()
        outs.append((rows.detach(), bag.detach()))
        grads.append(t.grad)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-6)
    with use_mesh(Mesh("model", (torch.device("cpu"),) * 5)):
        with pytest.raises(ValueError, match="do not split"):
            embedding.lookup(table, idx.clamp(min=0))


def test_bert4rec_mesh_serve_equals_the_direct_path():
    """The `"model"`-mesh serve (a local top-k over each entry's 128 table
    rows, the 4 x k candidates merged on the first entry) == the direct
    path, with k past the catalog so -inf ties cross the entries."""
    jcfg, tcfg, jp, tp, _, _ = _arch("bert4rec")
    seq = torch.from_numpy(np.random.default_rng(4).integers(
        0, 65, (5, jcfg.seq_len)).astype(np.int32))
    with torch.no_grad():
        direct = T.bert4rec_serve(tp, {"seq": seq}, tcfg, k=100)
        with use_mesh(CPU4):
            sharded = T.bert4rec_serve(tp, {"seq": seq}, tcfg, k=100, chunk=3)
            naive = T.bert4rec_serve(tp, {"seq": seq}, tcfg, k=100, naive=True)
    for got in (sharded, naive):
        assert torch.equal(got[1], direct[1])
        assert torch.equal(got[0], direct[0])


def test_deepfm_killed_and_resumed_equals_an_uninterrupted_run(tmp_path):
    """DeepFM's SMOKE config at a batch of 4096 rows (24576 lookups into
    300 table rows): a run that fails at step 3, resumed to step 5 from its
    checkpoint, equals an uninterrupted run bit for bit, losses and every
    state leaf (the lookup's backward adds duplicates in a fixed order)."""
    from repro_torch.configs import deepfm
    from repro_torch.train.trainer import DriverConfig, TrainingDriver
    cfg = deepfm.SMOKE
    rng = np.random.default_rng(0)
    batch = {"feat_ids": torch.from_numpy(rng.integers(0, 50, (4096, 6)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 2, 4096).astype(np.float32))}
    init_state, train_step = make_train_step(
        lambda p, b: T.deepfm_loss(p, b, cfg),
        OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=100))

    def run(name, **kw):
        d = DriverConfig(ckpt_dir=str(tmp_path / name), max_steps=5, keep_last=1, **kw)
        return TrainingDriver(init_state, train_step, d).run(
            lambda: T.deepfm_init(torch.Generator("cpu").manual_seed(0), cfg),
            iter([batch] * 5))
    with pytest.raises(RuntimeError, match="injected failure"):
        run("resumed", ckpt_every=3, fail_at_step=3)
    resumed, hist_r = run("resumed", ckpt_every=3)
    whole, hist_w = run("whole", ckpt_every=5)
    assert [h["loss"] for h in hist_r] == [h["loss"] for h in hist_w[3:]]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed), tree.leaves(whole)))
