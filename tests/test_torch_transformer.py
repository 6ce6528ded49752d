"""The port's dense transformer serving path (forward, lm_serve prefill,
decode_step) against the reference's, on gemma2-2b's SMOKE config (2 layers,
d 64, window 8, both softcaps) with the reference's `init_params` carried
over by `convert.transformer_params_from_numpy`. f32 runs at rtol = atol =
1e-4 (1e-3 for the 12-step decode chain); one bf16 run at a looser stated
tolerance, since XLA and torch round bf16 products and elementwise ops at
different places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jgemma
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import gemma2_2b as tgemma
from repro_torch.configs import registry as tregistry
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT

# bf16: activations of magnitude ~1 carry 2^-8 = 0.004 ulps; two layers of
# differently rounded products and norms stay within a few of them
BF16_TOL = 5e-2


def _cfgs(dtype: str):
    return (dataclasses.replace(jgemma.SMOKE, dtype=dtype),
            dataclasses.replace(tgemma.SMOKE, dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = JT.init_params(jax.random.key(seed), jcfg)
    tp = convert.transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
def test_forward_hidden_states(dtype, tol):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24)
    want, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == tcfg.adtype and float(aux) == 0.0
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
def test_prefill_logits(dtype, tol):
    """lm_serve's prefill: last-token logits without the final softcap."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 20)
    want = jregistry.lm_serve(jcfg, "prefill_32k")(jp, {"tokens": jnp.asarray(toks)})
    got = tregistry.lm_serve(tcfg, "prefill_32k")(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, tcfg.vocab_size)
    _close(got, want, tol)


def test_decode_steps_logits_and_cache():
    """12 decode steps from an empty cache: logits and the updated cache
    equal the reference's at each step (f32, 1e-3 for the chain)."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 12, seed=3)
    jcache = JT.init_cache(jcfg, 2, 16)
    tcache = TT.init_cache(tcfg, 2, 16, device="cpu")
    jstep = jregistry.lm_serve(jcfg, "decode_32k")
    tstep = tregistry.lm_serve(tcfg, "decode_32k")
    for i in range(12):
        want, jcache = jstep(jp, {"cache": jcache, "tokens": jnp.asarray(toks[:, i:i + 1]),
                                  "cur_len": jnp.int32(i)})
        got, tcache = tstep(tp, {"cache": tcache, "tokens": torch.from_numpy(toks[:, i:i + 1]),
                                 "cur_len": i})
        _close(got, want, 1e-3)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], 1e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", BF16_TOL)])
def test_decode_matches_forward_with_window(dtype, tol):
    """The port's own: teacher-forcing 12 tokens through decode_step gives
    forward's softcapped logits at every position (window 4 < 12, so the
    local layer's window is exercised); the reference's test_models check,
    on the port's own init_params."""
    cfg = TT.TransformerConfig(
        name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
        d_ff=64, vocab_size=64, local_window=4, global_every=2,
        attn_softcap=50.0, final_softcap=30.0, dtype=dtype)
    params = TT.serving_params(TT.init_params(torch.Generator().manual_seed(0), cfg), cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 12))
    h, _ = TT.forward(params, toks, cfg)
    full = tcommon.softcap((h @ TT.unembed_matrix(params, cfg).to(h.dtype)).float(),
                           cfg.final_softcap)
    cache = TT.init_cache(cfg, 1, 16, device="cpu")
    for i in range(12):
        step, cache = TT.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), rtol=tol, atol=tol)


def test_serving_params_gives_the_same_numbers():
    """The one-time cast to the activation dtype changes no output."""
    cfg = tgemma.SMOKE
    params = TT.init_params(torch.Generator().manual_seed(2), cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    a, _ = TT.forward(params, toks, cfg)
    b, _ = TT.forward(TT.serving_params(params, cfg), toks, cfg)
    assert torch.equal(a, b)


def test_gemma2_2b_config_matches_reference():
    j, t = jgemma.CONFIG, tgemma.CONFIG
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count() == 2614222080
    assert t.is_global_layer() == j.is_global_layer().tolist()
    assert [TT._window_of(t, f) for f in t.is_global_layer()[:4]] == [4096, None, 4096, None]
    assert dataclasses.asdict(tgemma.SMOKE) == dataclasses.asdict(jgemma.SMOKE)


def test_registry_cells_match_reference():
    tarch, jarch = tregistry.get_arch("gemma2-2b"), jregistry.get_arch("gemma2-2b")
    assert tarch.shapes == jarch.shapes and tarch.skips == jarch.skips
    assert tarch.config_for("decode_32k") is tgemma.CONFIG
    mesh = jax.make_mesh((1,), ("data",))
    pre = jregistry.lm_cell(jgemma.CONFIG, "prefill_32k", mesh, 1)
    assert tarch.cell_for("prefill_32k").dims == dict(
        zip(("batch", "seq_len"), pre.inputs["tokens"].shape))
    for shape in ("decode_32k", "long_500k"):
        ref = jregistry.lm_cell(jgemma.CONFIG, shape, mesh, 1)
        cell = tarch.cell_for(shape)
        assert cell.kind == ref.kind == "decode"
        assert cell.dims["cache"] == ref.inputs["cache"]["k"].shape
        assert (cell.dims["batch"], 1) == ref.inputs["tokens"].shape
    with pytest.raises(NotImplementedError):
        tarch.cell_for("train_4k")


def test_moe_configs_are_refused():
    cfg = dataclasses.replace(tgemma.SMOKE, moe=object())
    with pytest.raises(NotImplementedError, match="MoE"):
        TT.init_params(torch.Generator().manual_seed(0), cfg)


def test_entry_points_without_device_raise_when_there_is_no_card(monkeypatch):
    """The cache and the converted weights go to the card unless the caller
    names a device; with no card they raise instead of landing on the CPU."""
    jcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.transformer_params_from_numpy(tree, tcfg)
    assert TT.init_cache(tcfg, 1, 8, device="cpu")["k"].device == torch.device("cpu")
