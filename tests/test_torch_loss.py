"""The port's training loss against the reference's: `loss_fn` (xent +
0.01 * aux), `chunked_cross_entropy` and every gradient leaf against
`jax.grad` of the reference's `loss_fn`, on the SMOKE configs of the five
LMs with the reference's converted `init_params` (norm scales drawn away
from zero, as in tests/test_torch_transformer.py). f32 per leaf within
1e-4 x max|g_ref| + 1e-6 (MoE at the SMOKE capacity, drops included); bf16
at the transformer tests' BF16_TOL, an MoE model at the capacity that drops
nothing and with the tokens whose routing has a gate near-tie left out of
the loss (labels -100), as the transformer tests leave them out; remat on
and off; the registry's train cells, training setup and smoke batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch.configs import registry as tregistry
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.train import tree
from test_torch_transformer import BF16_TOL, MOES, SMOKES, _cfgs, _near_ties, \
    _params, _tokens

F32_TOL = 1e-4


def _labels(toks, ignore=None):
    lab = toks.copy()
    lab[0, :3] = -100
    if ignore is not None:
        lab[ignore] = -100
    return lab


def _jax_loss_grads(jp, toks, lab, jcfg):
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lab)}
    (loss, met), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg), has_aux=True)(jp)
    return float(loss), {k: float(v) for k, v in met.items()}, \
        dict(tree.leaves_with_paths(jax.tree.map(np.asarray, grads)))


def _torch_loss_grads(tp, toks, lab, tcfg):
    leaves = tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = TT.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(lab)}, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = [p for p, _ in tree.leaves_with_paths(tp)]
    return float(loss.detach()), {k: float(v.detach()) for k, v in met.items()}, \
        dict(zip(paths, (g.float().numpy() for g in grads)))


def _grads_close(got: dict, want: dict, tol: float):
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = np.abs(got[path] - w).max()
        assert err <= tol * np.abs(w).max() + 1e-6, (path, err, np.abs(w).max())


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", SMOKES)
def test_loss_and_every_gradient_match_reference(arch, dtype, tol, monkeypatch):
    jcfg, tcfg = _cfgs(arch, dtype, no_drops=dtype == "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24)
    ties = _near_ties(tp, toks, tcfg, monkeypatch)
    assert ties.mean() <= 0.5, ties
    lab = _labels(toks, ties)
    want_loss, want_met, want_g = _jax_loss_grads(jp, toks, lab, jcfg)
    got_loss, got_met, got_g = _torch_loss_grads(tp, toks, lab, tcfg)
    np.testing.assert_allclose(got_loss, want_loss, rtol=tol, atol=tol)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(got_met[k], want_met[k], rtol=tol, atol=tol)
    assert got_loss == pytest.approx(got_met["xent"] + 0.01 * got_met["aux"], rel=1e-6)
    _grads_close(got_g, want_g, tol)


@pytest.mark.parametrize("arch", ["gemma2-2b", "kimi-k2-1t-a32b"])
def test_remat_on_and_off_give_equal_gradients(arch):
    """Checkpointing each layer recomputes it with the same operations on
    the same inputs: the gradients are bit-equal."""
    _, tcfg = _cfgs(arch, "float32")
    _, tp = _params(*_cfgs(arch, "float32"))
    toks = _tokens(tcfg, 2, 16, seed=4)
    lab = _labels(toks)
    outs = [_torch_loss_grads(tp, toks, lab, dataclasses.replace(tcfg, remat=r))
            for r in (True, False)]
    assert outs[0][0] == outs[1][0]
    for path, g in outs[0][2].items():
        np.testing.assert_array_equal(g, outs[1][2][path], err_msg=path)


def test_serving_forward_takes_no_checkpoint(monkeypatch):
    """Parameters that need no gradient (serving) run the plain layer loop."""
    _, tcfg = _cfgs("internlm2-1.8b", "float32")
    _, tp = _params(*_cfgs("internlm2-1.8b", "float32"))
    monkeypatch.setattr(TT, "checkpoint", lambda *a, **k: pytest.fail("checkpointed"))
    TT.forward(tp, torch.from_numpy(_tokens(tcfg, 1, 8)), tcfg)


@pytest.mark.parametrize("cap,chunk,s", [(None, 512, 24), (30.0, 8, 20), (None, 7, 20)])
def test_chunked_cross_entropy_and_grads(cap, chunk, s):
    """The loss, and its gradient in hidden and unembed, equal the
    reference's, chunks that do not divide S and -100 labels included."""
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, s, 32)).astype(np.float32)
    u = (rng.standard_normal((32, 96)) / 6).astype(np.float32)
    lab = rng.integers(0, 96, (2, s)).astype(np.int32)
    lab[1, ::3] = -100

    def jloss(h, u):
        return jcommon.chunked_cross_entropy(h, u, jnp.asarray(lab), cap=cap, chunk=chunk)
    want, (gh, gu) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(u))
    th, tu = (torch.tensor(x, requires_grad=True) for x in (h, u))
    got = tcommon.chunked_cross_entropy(th, tu, torch.from_numpy(lab), cap=cap, chunk=chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(gu), rtol=1e-5, atol=1e-7)
    # every label ignored: 0, as the reference's max(cnt, 1)
    none = torch.full((2, s), -100, dtype=torch.int32)
    assert float(tcommon.chunked_cross_entropy(th, tu, none, chunk=chunk)) == 0.0


@pytest.mark.parametrize("arch", SMOKES)
def test_registry_train_cells_and_setup_match_reference(arch):
    """train_4k's batch, length and microbatches, the optimizer, the
    accumulation dtype, the registry's loss and the smoke batch equal the
    reference's."""
    tarch, jarch = tregistry.get_arch(arch), jregistry.get_arch(arch)
    mesh = jax.make_mesh((1,), ("data",))
    jcell = jarch.cell_for("train_4k", mesh)
    cell = tarch.cell_for("train_4k")
    toks = jcell.inputs["tokens"].shape
    assert cell.kind == jcell.kind == "train"
    assert cell.dims == {"batch": toks[-3] * toks[-2] if len(toks) == 3 else toks[0],
                         "seq_len": toks[-1], "n_micro": jcell.n_micro}
    assert tarch.n_micro == jcell.n_micro
    assert (tarch.optimizer, tarch.grad_accum_dtype) == (jarch.optimizer, jarch.grad_accum_dtype)
    jcfg, jbatch, jkind = jarch.smoke()
    tcfg, tbatch, tkind = tarch.smoke()
    assert tkind == jkind == "train"
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) | {"moe": dataclasses.asdict(
        tcfg.moe) if tcfg.moe else None}
    for k in ("tokens", "labels"):
        assert tbatch[k].dtype == torch.int32
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))


@pytest.mark.parametrize("arch", MOES[:1] + ["internlm2-1.8b"])
def test_registry_loss_is_loss_fn(arch):
    """`ArchSpec.loss_fn(cfg)` is `loss_fn` bound to the config, on the
    smoke batch."""
    tarch = tregistry.get_arch(arch)
    cfg, batch, _ = tarch.smoke()
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        a = tarch.loss_fn(cfg)(params, batch)
        b = TT.loss_fn(params, batch, cfg)
    assert float(a[0]) == float(b[0]) and a[1].keys() == {"xent", "aux"}
