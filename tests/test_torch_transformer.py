"""The port's transformer serving path (forward, lm_serve prefill,
decode_step) against the reference's, on the SMOKE configs of the five
ported LMs: gemma2-2b (2 layers, window 8, both softcaps), gemma3-12b (3
layers, window 8 on 2 of 3, QK-norm, no softcap), internlm2-1.8b (2
global layers, untied unembedding, no softcap), and the MoE models kimi-k2
(8 experts, top 2) and llama4 (4 experts, top 1), at the SMOKE capacity
factor 2.0, which drops (token, choice) pairs in both packages alike. The reference's
`init_params` are carried over by `convert.transformer_params_from_numpy`,
with every norm scale drawn away from its zero init (so a scale applied
wrongly, the QK-norm's included, shows). f32 runs at rtol = atol = 1e-4
(1e-3 for the 12-step decode chain); bf16 at a looser stated tolerance,
since XLA and torch round bf16 products and elementwise ops at different
places."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as jgemma
from repro.configs import gemma3_12b as jgemma3
from repro.configs import internlm2_1_8b as jintern
from repro.configs import kimi_k2_1t_a32b as jkimi
from repro.configs import llama4_maverick_400b_a17b as jllama4
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import gemma2_2b as tgemma
from repro_torch.configs import gemma3_12b as tgemma3
from repro_torch.configs import internlm2_1_8b as tintern
from repro_torch.configs import kimi_k2_1t_a32b as tkimi
from repro_torch.configs import llama4_maverick_400b_a17b as tllama4
from repro_torch.configs import registry as tregistry
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT

# bf16: activations of magnitude ~1 carry 2^-8 = 0.004 ulps; two layers of
# differently rounded products and norms stay within a few of them
BF16_TOL = 5e-2
NEAR_TIE = 2.0 ** -6        # f32 gate-probability gap under which bf16 may route otherwise

# arch name -> (reference config module, port config module)
ARCHS = {"gemma2-2b": (jgemma, tgemma), "gemma3-12b": (jgemma3, tgemma3),
         "internlm2-1.8b": (jintern, tintern),
         "kimi-k2-1t-a32b": (jkimi, tkimi),
         "llama4-maverick-400b-a17b": (jllama4, tllama4)}
SMOKES = list(ARCHS)
MOES = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]
_NORMS = ("ln1", "ln2", "qnorm", "knorm", "final_norm")


def _cfgs(arch: str, dtype: str, no_drops: bool = False):
    """The reference's and the port's SMOKE config in `dtype`; with
    `no_drops`, an MoE config at the capacity that drops nothing
    (`_no_drops`)."""
    jmod, tmod = ARCHS[arch]
    j, t = (dataclasses.replace(m.SMOKE, dtype=dtype) for m in (jmod, tmod))
    return (_no_drops(j), _no_drops(t)) if no_drops else (j, t)


def _no_drops(cfg):
    """`cfg` with an MoE capacity factor of E / k, at which no (token,
    choice) pair drops. A decode step's capacity comes from its B tokens and
    a forward's from B*S, so at the SMOKE factor the two drop different
    pairs and their logits differ by up to ~3.5, in the reference too; only
    a capacity that drops nothing makes decode == forward hold for MoE."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


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


def _near_ties(tp, toks, tcfg, monkeypatch) -> np.ndarray:
    """[B, S] bool: the tokens a bf16 MoE run may route otherwise than the
    reference. XLA and torch round bf16 products at different places, so
    where two of a token's k + 1 largest gate probabilities lie within
    NEAR_TIE (2^-6, from the f32 gate on the layer's input) in some layer,
    its expert set may differ and its output with it, by O(1). Only at a
    capacity that drops nothing does such a flip stay with its token (with
    drops it moves other tokens' capacity ranks), so the bf16 MoE cases run
    there; f32 holds the drops. (Through the next layer's attention a flip
    moves a later position by one attention weight of its change, which the
    tolerance holds.) None are marked for a dense model or f32."""
    b, s = toks.shape
    ties = np.zeros((b, s), bool)
    if tcfg.moe is None or tcfg.dtype == "float32":
        return ties
    inner = tmoe._route

    def spy(params, x, cfg):
        out = inner(params, x, cfg)
        probs = torch.softmax(x.float() @ params["gate"].float(), dim=-1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        ties[...] |= ((top[:, :-1] - top[:, 1:]).min(-1).values
                      <= NEAR_TIE).numpy().reshape(b, s)
        _, keep = tmoe.capacity_slots(out[0], 0, cfg.n_experts,
                                      tmoe.capacity(x.shape[0], cfg))
        assert bool(keep.all()), "bf16 MoE cases run at a capacity that drops nothing"
        return out
    monkeypatch.setattr(tmoe, "_route", spy)
    TT.forward(tp, torch.from_numpy(toks), tcfg)
    monkeypatch.undo()
    return ties


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", SMOKES)
def test_forward_hidden_states(arch, dtype, tol, monkeypatch):
    """Hidden states and aux equal the reference's, MoE drops included in
    f32; in bf16 an MoE model runs at the capacity that drops nothing and is
    held at the tokens with no near-tie routing (`_near_ties`)."""
    jcfg, tcfg = _cfgs(arch, dtype, no_drops=dtype == "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24)
    want, want_aux = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == tcfg.adtype and aux.dtype == torch.float32
    keep = ~_near_ties(tp, toks, tcfg, monkeypatch)
    assert keep.mean() >= 0.5, keep
    _close(got[torch.from_numpy(keep)], np.asarray(want, np.float32)[keep], tol)
    _close(aux, want_aux, tol)


@pytest.mark.parametrize("arch", SMOKES)
def test_forward_aux_loss(arch):
    """forward's aux is the f32 sum over layers of the Switch load-balance
    loss E * sum(mean(probs) * mean(one_hot(top-1))), as the reference's
    (1e-5); a dense model's is 0. Checked against the port's own `_route`
    on each layer's input."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 24, seed=5)
    _, want = JT.forward(jp, jnp.asarray(toks), jcfg)
    _, got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want, 1e-5)
    if tcfg.moe is None:
        assert float(got) == 0.0
        return
    # the same sum from each layer's routing, layer by layer
    h = TT._embed(tp, torch.from_numpy(toks), tcfg)
    pos = torch.arange(toks.shape[1])
    total = 0.0
    for i in range(tcfg.n_layers):
        lp = TT.layer_params(tp, i)
        h = h + TT._attention_block(tcfg, lp, h, None, positions=pos)
        m = tcommon.rms_norm(h, lp["ln2"]).reshape(-1, tcfg.d_model)
        total += float(tmoe._route(lp["ffn"], m, tcfg.moe)[2])
        h = h + TT._ffn_block(tcfg, lp, h)[0]
    assert abs(total - float(got)) < 1e-5
    assert 0.5 < float(got) / tcfg.n_layers < tcfg.moe.n_experts


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", SMOKES)
def test_prefill_logits(arch, dtype, tol, monkeypatch):
    """lm_serve's prefill: last-token logits without the final softcap
    (through the untied unembedding on internlm2 and the MoE models); in
    bf16 an MoE model as in test_forward_hidden_states, at the rows whose
    last token routes with no near-tie."""
    jcfg, tcfg = _cfgs(arch, dtype, no_drops=dtype == "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, 20)
    want = jregistry.lm_serve(jcfg, "prefill_32k")(jp, {"tokens": jnp.asarray(toks)})
    got = tregistry.lm_serve(tcfg, "prefill_32k")(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, tcfg.vocab_size)
    rows = ~_near_ties(tp, toks, tcfg, monkeypatch)[:, -1]
    assert rows.any(), "every row's last token is reached by a near-tie"
    _close(got[torch.from_numpy(rows)], np.asarray(want, np.float32)[rows], tol)


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
    check. The MoE configs run at a capacity that drops nothing
    (`_no_drops`)."""
    jcfg, cfg = _cfgs(arch, dtype, no_drops=True)
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
        "internlm2-1.8b": (1889110016, [None] * 6),
        "kimi-k2-1t-a32b": (1042174407680, [None] * 6),
        "llama4-maverick-400b-a17b": (778214937600, [None] * 6)}


@pytest.mark.parametrize("arch", SMOKES)
def test_config_matches_reference(arch):
    """CONFIG and SMOKE equal the reference's field for field: gemma3's one
    rope_theta for every layer and QK-norm, internlm2's untied unembedding,
    neither with a softcap."""
    (jmod, tmod), (count, windows) = ARCHS[arch], FULL[arch]
    j, t = jmod.CONFIG, tmod.CONFIG
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count() == count
    assert t.active_param_count() == j.active_param_count()
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
    train = jregistry.lm_cell(ARCHS[arch][0].CONFIG, "train_4k", mesh, jarch.cell_for(
        "train_4k", mesh).n_micro)
    assert tarch.cell_for("train_4k").kind == train.kind == "train"
    assert tarch.cell_for("train_4k").dims["seq_len"] == train.inputs["tokens"].shape[-1]


@pytest.mark.parametrize("arch", MOES)
def test_moe_init_params_shapes_scales_and_dtype(arch):
    """init_params builds the MoE leaves stacked on [L] with the reference's
    shapes, in the config's param dtype (bf16 drawn in f32 chunks, cast),
    with the reference's scales: gate, w1, w3 1/sqrt(D), w2 1/sqrt(F) (not
    divided by sqrt(2L)), wo 1/sqrt(Hq*Dh)/sqrt(2L)."""
    jcfg, tcfg = _cfgs(arch, "float32")
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    ref = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    got = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = TT._map_path(lambda path, a: (path, a), got)
    d, f, l = tcfg.d_model, tcfg.moe.d_expert, tcfg.n_layers
    stds = {"gate": d, "w1": d, "w3": d, "w2": f}
    for name, fan in stds.items():
        a = flat["layers"]["ffn"][name][1]
        assert a.shape == ref["layers"]["ffn"][name].shape and a.dtype == torch.bfloat16
        assert abs(float(a.float().std()) * math.sqrt(fan) - 1) < 0.1, name
    wo = got["layers"]["attn"]["wo"].float()
    assert abs(float(wo.std()) * math.sqrt(tcfg.n_heads * tcfg.d_head * 2 * l) - 1) < 0.1
    assert got["embed"].dtype == torch.bfloat16


def test_chunked_init_fills_every_row(monkeypatch):
    """A bf16 leaf larger than one chunk is filled chunk by chunk, every row
    drawn (no row left at torch.empty's contents), at the asked scale."""
    monkeypatch.setattr(TT, "_CHUNK", 100)
    a = TT._normal(torch.Generator().manual_seed(0), (3, 70, 30), 0.5, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
    assert bool((a.float().abs().sum(-1) > 0).all())
    assert abs(float(a.float().std()) / 0.5 - 1) < 0.05


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
