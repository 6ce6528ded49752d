"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`): the same numpy-seeded tokens and weights go through
both, the weights carried across by `convert.tensors_from_numpy`. f32 at
rtol = atol = 1e-5, capacity drops included (both packages keep the same
(token, choice) pairs); bf16 with routing equal but at near-ties of the f32
gate. Expert parallelism runs on a `"model"` mesh of 4 CPU entries."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.distributed import Mesh, use_mesh
from repro_torch.models import moe as tmoe

D = 32
F_EXPERT = 48
TOL = 1e-5
BF16_TOL = 5e-2
NEAR_TIE = 2.0 ** -6          # f32 probability gap under which bf16 may route otherwise
EKS = [(8, 2), (4, 1), (16, 4)]
CPU4 = Mesh("model", (torch.device("cpu"),) * 4)


def _cfg(e, k, cf):
    return tmoe.MoEConfig(n_experts=e, top_k=k, d_expert=F_EXPERT, capacity_factor=cf)


def _weights(e, seed=0):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return {"gate": (n((D, e)) / math.sqrt(D)).astype(np.float32),
            "w1": (n((e, D, F_EXPERT)) / math.sqrt(D)).astype(np.float32),
            "w3": (n((e, D, F_EXPERT)) / math.sqrt(D)).astype(np.float32),
            "w2": (n((e, F_EXPERT, D)) / math.sqrt(F_EXPERT)).astype(np.float32)}


def _x(t, seed=1):
    return np.random.default_rng(seed).standard_normal((t, D)).astype(np.float32)


def _both(e, t, dtype=torch.float32, seed=0):
    """(reference params, port params, reference x, port x) in `dtype`."""
    w, x = _weights(e, seed), _x(t, seed + 1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = convert.tensors_from_numpy(w, device="cpu")
    return jp, tp, jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)


def _jcfg(cfg):
    return jmoe.MoEConfig(**dataclasses.asdict(cfg))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_config_equals_reference():
    for e, k in EKS:
        cfg = _cfg(e, k, 1.25)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(_jcfg(cfg))
    assert dataclasses.asdict(tmoe.MoEConfig(8, 2, 16)) == \
        dataclasses.asdict(jmoe.MoEConfig(8, 2, 16))


@pytest.mark.parametrize("e,k", EKS)
def test_route_matches_reference(e, k):
    cfg = _cfg(e, k, 1.25)
    jp, tp, jx, tx = _both(e, 53)
    je, jpr, jaux = jmoe._route(jp, jx, _jcfg(cfg))
    te, tpr, taux = tmoe._route(tp, tx, cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tpr.dtype == torch.float32 and taux.dtype == torch.float32
    _close(tpr, jpr)
    _close(taux, jaux)
    _close(tpr.sum(-1), np.ones(53))


def _slots_by_onehot(topk_e, lo, e_local, cap_e):
    """The reference's rank rule, written out with a one-hot cumsum."""
    e_flat = topk_e.reshape(-1)
    local = (e_flat >= lo) & (e_flat < lo + e_local)
    e_loc = np.where(local, e_flat - lo, 0)
    onehot = (e_loc[:, None] == np.arange(e_local)[None, :]) & local[:, None]
    pos = ((np.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    keep = local & (pos < cap_e)
    slot = np.where(keep, e_loc * cap_e + pos, e_local * cap_e)
    return slot.reshape(topk_e.shape), keep.reshape(topk_e.shape)


@pytest.mark.parametrize("lo,e_local,cap_e", [(0, 8, 1), (0, 8, 3), (4, 4, 2),
                                              (2, 2, 7), (0, 8, 100)])
def test_capacity_slots_equal_the_onehot_cumsum(lo, e_local, cap_e):
    """The stable sort's ranks keep and drop exactly the reference's pairs."""
    topk_e = np.random.default_rng(lo + 10 * cap_e).integers(0, 8, (61, 3))
    slot, keep = tmoe.capacity_slots(torch.from_numpy(topk_e), lo, e_local, cap_e)
    want_slot, want_keep = _slots_by_onehot(topk_e, lo, e_local, cap_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)


@pytest.mark.parametrize("cf", [4.0, 1.25, 0.25])
@pytest.mark.parametrize("e,k", EKS)
@pytest.mark.parametrize("t", [37, 64])
def test_moe_apply_matches_reference_f32(e, k, cf, t):
    """T = 37 does not divide evenly into any expert count; at capacity
    factor 0.25 (and 1.25 for the busier experts) pairs are dropped."""
    cfg = _cfg(e, k, cf)
    jp, tp, jx, tx = _both(e, t)
    want, jaux = jmoe.moe_apply(jp, jx, _jcfg(cfg))
    got, taux = tmoe.moe_apply(tp, tx, cfg)
    assert got.shape == (t, D) and got.dtype == torch.float32
    _close(got, want)
    _close(taux, jaux)
    if cf == 0.25:
        te, _, _ = tmoe._route(tp, tx, cfg)
        _, keep = tmoe.capacity_slots(te, 0, e, tmoe.capacity(t, cfg))
        assert not bool(keep.all())


def _margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the smallest gap between consecutive probabilities among
    the k + 1 largest: a routing whose order or set may flip under bf16."""
    top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    return (top[:, :-1] - top[:, 1:]).min(-1).values


@pytest.mark.parametrize("e,k", EKS)
def test_moe_apply_matches_reference_bf16(e, k):
    """bf16 at a capacity that drops nothing (E / k): the routing equals the
    reference's but at near-ties of the f32 gate (margin <= 2^-6), and every
    token routed alike has an output within 5e-2."""
    cfg = _cfg(e, k, e / k)
    jp, tp, jx, tx = _both(e, 96, torch.bfloat16)
    want, _ = jmoe.moe_apply(jp, jx, _jcfg(cfg))
    got, _ = tmoe.moe_apply(tp, tx, cfg)
    assert got.dtype == torch.bfloat16
    je = np.asarray(jmoe._route(jp, jx, _jcfg(cfg))[0])
    te = tmoe._route(tp, tx, cfg)[0].numpy()
    same = (je == te).all(-1)
    probs = torch.softmax(tx.float() @ tp["gate"], dim=-1)
    margin = _margin(probs, k).numpy()
    assert (margin[~same] <= NEAR_TIE).all(), margin[~same]
    assert same.mean() > 0.9
    np.testing.assert_allclose(got.float().numpy()[same],
                               np.asarray(want, np.float32)[same],
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("e,k", EKS)
def test_dense_oracle_matches_reference(e, k):
    cfg = _cfg(e, k, 1.25)
    jp, tp, jx, tx = _both(e, 29)
    _close(tmoe.moe_apply_dense_oracle(tp, tx, cfg),
           jmoe.moe_apply_dense_oracle(jp, jx, _jcfg(cfg)))


@pytest.mark.parametrize("e,k", EKS)
def test_no_drop_capacity_equals_the_oracle(e, k):
    """At capacity factor E / k every pair fits: moe_apply is the oracle."""
    cfg = _cfg(e, k, e / k)
    _, tp, _, tx = _both(e, 41)
    _close(tmoe.moe_apply(tp, tx, cfg)[0], tmoe.moe_apply_dense_oracle(tp, tx, cfg))


@pytest.mark.parametrize("cf", [4.0, 0.25])
@pytest.mark.parametrize("e,k", EKS)
def test_expert_parallel_on_four_cpu_entries(e, k, cf):
    """Entry r holds experts [r E/4, (r+1) E/4) and the partial outputs are
    summed on the first entry: equal to the one-entry call and to the
    reference's moe_apply (drops included at 0.25), and at 4.0, where no
    pair drops for these (E, k), to both dense oracles."""
    cfg = _cfg(e, k, cf)
    jp, tp, jx, tx = _both(e, 45)
    direct, aux = tmoe.moe_apply(tp, tx, cfg)
    with use_mesh(CPU4):
        got, ep_aux = tmoe.moe_apply(tp, tx, cfg)
    assert torch.equal(ep_aux, aux)
    _close(got, direct)
    want, _ = jmoe.moe_apply(jp, jx, _jcfg(cfg))
    _close(got, want)
    if cf == 4.0:
        _close(got, tmoe.moe_apply_dense_oracle(tp, tx, cfg))
        _close(got, jmoe.moe_apply_dense_oracle(jp, jx, _jcfg(cfg)))


def test_expert_parallel_shards_are_views_on_one_device(monkeypatch):
    """Each entry's experts are slices of the stacked weights (no copy on
    one device), and entry r's dispatch runs with rank r."""
    cfg = _cfg(8, 2, 1.25)
    _, tp, _, tx = _both(8, 30)
    seen = []
    inner = tmoe._dispatch_local

    def spy(x, te, tpr, w1, w3, w2, **kw):
        seen.append((kw["rank"], w1.data_ptr() - tp["w1"].data_ptr(), w1.shape[0]))
        return inner(x, te, tpr, w1, w3, w2, **kw)
    monkeypatch.setattr(tmoe, "_dispatch_local", spy)
    with use_mesh(CPU4):
        tmoe.moe_apply(tp, tx, cfg)
    step = 2 * D * F_EXPERT * 4
    assert seen == [(r, r * step, 2) for r in range(4)]


def test_expert_count_must_divide_over_the_model_axis():
    cfg = _cfg(8, 2, 1.25)
    _, tp, _, tx = _both(8, 16)
    with use_mesh(Mesh("model", (torch.device("cpu"),) * 3)):
        with pytest.raises(AssertionError):
            tmoe.moe_apply(tp, tx, cfg)


def test_a_mesh_without_a_model_axis_takes_the_direct_path():
    cfg = _cfg(16, 4, 0.25)
    _, tp, _, tx = _both(16, 33)
    direct, _ = tmoe.moe_apply(tp, tx, cfg)
    with use_mesh(Mesh("shard", (torch.device("cpu"),) * 4)):
        assert torch.equal(tmoe.moe_apply(tp, tx, cfg)[0], direct)


@pytest.mark.parametrize("t,cf,want", [(1, 1.25, 1), (8, 1.25, 3), (37, 0.25, 3),
                                       (32768, 1.25, 10240)])
def test_capacity_is_the_references(t, cf, want):
    cfg = _cfg(8, 2, cf)
    assert tmoe.capacity(t, cfg) == want == max(1, math.ceil(t * 2 * cf / 8))


def test_init_moe_params_shapes_and_scales():
    cfg = tmoe.MoEConfig(n_experts=8, top_k=2, d_expert=512)
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 256, cfg)
    ref = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.key(0), 256,
                                                        _jcfg(cfg)))
    stds = {"gate": 1 / 16, "w1": 1 / 16, "w3": 1 / 16, "w2": 1 / math.sqrt(512)}
    for name, std in stds.items():
        assert p[name].shape == ref[name].shape and p[name].dtype == torch.float32
        assert abs(float(p[name].std()) / std - 1) < 0.03, name
        assert abs(float(ref[name].std()) / std - 1) < 0.03, name
        assert abs(float(p[name].mean())) < 4 * std / math.sqrt(p[name].numel()), name
