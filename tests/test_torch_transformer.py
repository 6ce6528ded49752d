"""The port's dense transformer serving path (forward, lm_serve prefill,
decode_step) against the reference's, on the SMOKE configs of the three
ported LMs: gemma2-2b (2 layers, window 8, both softcaps), gemma3-12b (3
layers, window 8 on 2 of 3, QK-norm, no softcap) and internlm2-1.8b (2
global layers, untied unembedding, no softcap). The reference's
`init_params` are carried over by `convert.transformer_params_from_numpy`,
with every norm scale drawn away from its zero init (so a scale applied
wrongly, the QK-norm's included, shows). f32 runs at rtol = atol = 1e-4
(1e-3 for the 12-step decode chain); bf16 at a looser stated tolerance,
since XLA and torch round bf16 products and elementwise ops at different
places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jgemma
from repro.configs import gemma3_12b as jgemma3
from repro.configs import internlm2_1_8b as jintern
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import gemma2_2b as tgemma
from repro_torch.configs import gemma3_12b as tgemma3
from repro_torch.configs import internlm2_1_8b as tintern
from repro_torch.configs import registry as tregistry
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT

# bf16: activations of magnitude ~1 carry 2^-8 = 0.004 ulps; two layers of
# differently rounded products and norms stay within a few of them
BF16_TOL = 5e-2

# arch name -> (reference config module, port config module)
ARCHS = {"gemma2-2b": (jgemma, tgemma), "gemma3-12b": (jgemma3, tgemma3),
         "internlm2-1.8b": (jintern, tintern)}
SMOKES = list(ARCHS)
_NORMS = ("ln1", "ln2", "qnorm", "knorm", "final_norm")


def _cfgs(arch: str, dtype: str):
    jmod, tmod = ARCHS[arch]
    return (dataclasses.replace(jmod.SMOKE, dtype=dtype),
            dataclasses.replace(tmod.SMOKE, dtype=dtype))


def _norms_drawn(tree, rng):
    """The tree with every norm scale drawn from N(0, 0.2^2) (the init is
    zero, i.e. a scale of 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _norms_drawn(v, rng)
        elif k in _NORMS:
            out[k] = (0.2 * rng.standard_normal(v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _params(jcfg, tcfg, seed=0):
    tree = _norms_drawn(jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed), jcfg)),
                        np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.transformer_params_from_numpy(tree, tcfg, device="cpu")
    return jp, tp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", SMOKES)
def test_forward_hidden_states(arch, dtype, tol):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24)
    want, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == tcfg.adtype and float(aux) == 0.0
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", SMOKES)
def test_prefill_logits(arch, dtype, tol):
    """lm_serve's prefill: last-token logits without the final softcap
    (through the untied unembedding on internlm2)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 20)
    want = jregistry.lm_serve(jcfg, "prefill_32k")(jp, {"tokens": jnp.asarray(toks)})
    got = tregistry.lm_serve(tcfg, "prefill_32k")(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, tcfg.vocab_size)
    _close(got, want, tol)


@pytest.mark.parametrize("arch", SMOKES)
def test_decode_steps_logits_and_cache(arch):
    """12 decode steps from an empty cache: logits and the updated cache
    equal the reference's at each step (f32, 1e-3 for the chain; the
    window of 8 is passed at step 9)."""
    jcfg, tcfg = _cfgs(arch, "float32")
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
@pytest.mark.parametrize("arch", SMOKES)
def test_decode_matches_forward_with_window(arch, dtype, tol):
    """The port's own: teacher-forcing 16 tokens through decode_step gives
    forward's softcapped logits at every position (the SMOKE windows of 8 <
    16, so the local layers' windows are exercised), on the reference's
    converted params cast by `serving_params`; the reference's test_models
    check."""
    jcfg, cfg = _cfgs(arch, dtype)
    params = TT.serving_params(_params(jcfg, cfg)[1], cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    h, _ = TT.forward(params, toks, cfg)
    full = tcommon.softcap((h @ TT.unembed_matrix(params, cfg).to(h.dtype)).float(),
                           cfg.final_softcap)
    cache = TT.init_cache(cfg, 1, 16, device="cpu")
    for i in range(16):
        step, cache = TT.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", SMOKES)
def test_serving_params_gives_the_same_numbers(arch):
    """The one-time cast to the activation dtype changes no output."""
    cfg = ARCHS[arch][1].SMOKE
    params = TT.init_params(torch.Generator().manual_seed(2), cfg)
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    a, _ = TT.forward(params, toks, cfg)
    b, _ = TT.forward(TT.serving_params(params, cfg), toks, cfg)
    assert torch.equal(a, b)


# (param count, the first six layers' windows) of each full config
FULL = {"gemma2-2b": (2614222080, [4096, None, 4096, None, 4096, None]),
        "gemma3-12b": (11765419776, [1024] * 5 + [None]),
        "internlm2-1.8b": (1889110016, [None] * 6)}


@pytest.mark.parametrize("arch", SMOKES)
def test_config_matches_reference(arch):
    """CONFIG and SMOKE equal the reference's field for field: gemma3's one
    rope_theta for every layer and QK-norm, internlm2's untied unembedding,
    neither with a softcap."""
    (jmod, tmod), (count, windows) = ARCHS[arch], FULL[arch]
    j, t = jmod.CONFIG, tmod.CONFIG
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count() == count
    assert t.is_global_layer() == j.is_global_layer().tolist()
    assert [TT._window_of(t, f) for f in t.is_global_layer()[:6]] == windows
    assert dataclasses.asdict(tmod.SMOKE) == dataclasses.asdict(jmod.SMOKE)
    assert t.name == arch


@pytest.mark.parametrize("arch", SMOKES)
def test_registry_cells_match_reference(arch):
    tarch, jarch = tregistry.get_arch(arch), jregistry.get_arch(arch)
    cfg = ARCHS[arch][1].CONFIG
    assert tarch.shapes == jarch.shapes and tarch.skips == jarch.skips
    assert ("long_500k" in tarch.skips) == cfg.pure_full_attention
    assert tarch.config_for("decode_32k") is cfg
    mesh = jax.make_mesh((1,), ("data",))
    pre = jregistry.lm_cell(ARCHS[arch][0].CONFIG, "prefill_32k", mesh, 1)
    assert tarch.cell_for("prefill_32k").dims == dict(
        zip(("batch", "seq_len"), pre.inputs["tokens"].shape))
    for shape in ("decode_32k", "long_500k"):
        ref = jregistry.lm_cell(ARCHS[arch][0].CONFIG, shape, mesh, 1)
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
    jcfg, tcfg = _cfgs("gemma2-2b", "float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.transformer_params_from_numpy(tree, tcfg)
    assert TT.init_cache(tcfg, 1, 8, device="cpu")["k"].device == torch.device("cpu")
