"""Decoder-only transformer LM, the counterpart of
`repro.models.transformer`: prefill (`forward`), the KV-cache decode step
(`decode_step`) and the training loss (`loss_fn`), with GQA, RoPE,
local/global attention alternation,
attention and final logit softcaps, a tied or untied embedding, and a dense
SwiGLU or MoE FFN (`models.moe`).

Parameters are the reference's tree: a dict whose per-layer leaves are
stacked on a leading [L] axis. Each layer's attention runs on
`common.attention` (the hand-written `flash_attention` kernel on the card),
and the layer loop knows each layer's window statically: a global layer
passes `window=None`. The cache is updated in place.

The reference's rounding order is kept: the embedding is cast to the
activation dtype before the sqrt(d) scale, `rms_norm` and `rope` work in f32
and cast back, and weights are cast to the activation dtype at each matmul
(`serving_params` makes that cast once, with identical numbers). An MoE
layer runs on all of the call's tokens, so a decode step's expert capacity
comes from its B tokens and a forward's from B*S, as in the reference.
When autograd wants a gradient of the parameters (training), `forward`
checkpoints each layer if `cfg.remat`, as the reference wraps its layer in
`jax.checkpoint`: the backward recomputes a layer's activations from its
input, with the same kernels on the same inputs, so the numbers do not
change. Serving (parameters that need no gradient, or `torch.no_grad`)
runs the plain loop. `unroll_layers` and `attn_unroll` are dry-run knobs
of the reference that the port ignores.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import common, moe as moe_lib


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    moe: moe_lib.MoEConfig | None = None
    rope_theta: float = 10000.0
    local_window: int | None = None     # sliding window for local layers
    global_every: int = 0               # 0: all-global; n: every n-th layer global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma-style sqrt(D) embedding scale
    dtype: str = "bfloat16"             # activation dtype
    param_dtype: str = "float32"        # storage dtype (bf16 for 1T configs)
    remat: bool = True
    xent_chunk: int = 512
    attn_chunk: int = 1024
    pure_full_attention: bool = False   # True => long_500k cell is skipped
    unroll_layers: bool = False
    attn_unroll: bool = False

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def is_global_layer(self) -> list[bool]:
        if self.global_every <= 0 or self.local_window is None:
            return [True] * self.n_layers
        return [i % self.global_every == self.global_every - 1
                for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Exact parameter count (for MODEL_FLOPS = 6·N·D bookkeeping)."""
        p = self.vocab_size * self.d_model          # embed
        if not self.tie_embeddings:
            p += self.d_model * self.vocab_size
        per_layer = (self.d_model * (self.n_heads + 2 * self.n_kv_heads)
                     * self.d_head
                     + self.n_heads * self.d_head * self.d_model
                     + 2 * self.d_model)
        if self.qk_norm:
            per_layer += 2 * self.d_head
        if self.moe is not None:
            per_layer += self.d_model * self.moe.n_experts
            per_layer += self.moe.n_experts * 3 * self.d_model * self.moe.d_expert
        else:
            per_layer += 3 * self.d_model * self.d_ff
        return p + self.n_layers * per_layer + self.d_model

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        per_expert = self.n_layers * 3 * self.d_model * self.moe.d_expert
        return self.param_count() - (self.moe.n_experts - self.moe.top_k) * per_expert


# -----------------------------------------------------------------------------
# params
# -----------------------------------------------------------------------------

_CHUNK = 1 << 28      # f32 elements drawn at a time for a narrower dtype (1 GiB)


def _normal(gen: torch.Generator, shape: tuple[int, ...], std: float,
            dtype: torch.dtype) -> torch.Tensor:
    """N(0, std^2) in `dtype`, drawn in f32 and cast. A narrower dtype is
    filled in chunks of at most 2^28 f32 elements (whole rows of the last
    axis, in order), so a bf16 leaf never has an f32 copy of its size: one
    kimi-k2 layer's experts are 33.8 GB in bf16 and would be 67.6 GB in
    f32."""
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=gen.device) * std
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = out.view(-1, shape[-1])
    step = max(1, _CHUNK // shape[-1])
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        rows[i:i + n] = (torch.randn((n, shape[-1]), generator=gen, device=gen.device)
                         * std).to(dtype)
    return out


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Random parameters on `gen`'s device in `cfg.param_dtype`, with the
    reference's distributions and scales (not its numbers: the generators
    differ). Every matrix is normal / sqrt(fan_in) (`wo` and the dense `w2`
    also / sqrt(2L)), the embedding normal * 0.01, the MoE leaves those of
    `moe.init_moe_params` stacked on [L]; norm scales are zero."""
    d, h, kv, dh, l = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.n_layers)
    dev, pdt = gen.device, cfg.pdtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=dev)

    def dense(*shape, div=1.0):
        return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]) / div, pdt)

    if cfg.moe is None:
        ffn = {"w1": dense(l, d, cfg.d_ff),
               "w3": dense(l, d, cfg.d_ff),
               "w2": dense(l, cfg.d_ff, d, div=math.sqrt(2 * l))}
    else:
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        ffn = {"gate": dense(l, d, e),
               "w1": dense(l, e, d, f),
               "w3": dense(l, e, d, f),
               "w2": dense(l, e, f, d)}
    params = {
        "embed": _normal(gen, (cfg.vocab_size, d), 0.01, pdt),
        "layers": {
            "attn": {
                "wq": dense(l, d, h * dh),
                "wk": dense(l, d, kv * dh),
                "wv": dense(l, d, kv * dh),
                "wo": dense(l, h * dh, d, div=math.sqrt(2 * l)),
            },
            "ffn": ffn,
            "ln1": zeros(l, d),
            "ln2": zeros(l, d),
        },
        "final_norm": zeros(d),
    }
    if cfg.qk_norm:
        params["layers"]["qnorm"] = zeros(l, dh)
        params["layers"]["knorm"] = zeros(l, dh)
    if not cfg.tie_embeddings:
        params["unembed"] = dense(d, cfg.vocab_size)
    return params


_NORMS = ("ln1", "ln2", "qnorm", "knorm", "final_norm")


def serving_params(params: dict, cfg: TransformerConfig) -> dict:
    """The tree with every matrix (embedding included) cast once to the
    activation dtype; norm scales keep theirs. The per-matmul casts of the
    model are then no-ops, and the numbers are the same."""
    def cast(path, p):
        return p if path[-1] in _NORMS else p.to(cfg.adtype)
    return _map_path(cast, params)


def tree_map(fn, tree):
    """`fn` applied to every leaf of a nested dict of tensors."""
    return _map_path(lambda _, p: fn(p), tree)


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def layer_params(params: dict, i: int) -> dict:
    """Layer `i`'s slice of the stacked per-layer tree (views, no copy)."""
    return tree_map(lambda a: a[i], params["layers"])


def _all_layer_params(params: dict, n_layers: int) -> list[dict]:
    """Every layer's slice of the stacked tree (views), by one `unbind` a
    leaf: under autograd its backward stacks the L slices' gradients once,
    where a slice a[i] per layer would add L leaf-sized tensors (24 x 1.6
    GB for internlm2-1.8b's w1 alone)."""
    cols = tree_map(lambda a: a.unbind(0), params["layers"])
    return [tree_map(lambda c, i=i: c[i], cols) for i in range(n_layers)]


# -----------------------------------------------------------------------------
# forward
# -----------------------------------------------------------------------------

def _attention_block(cfg: TransformerConfig, lp: dict, h: torch.Tensor,
                     window: int | None, *, positions: torch.Tensor,
                     pos0: int = 0, kv_len: int | None = None,
                     cache_kv=None) -> torch.Tensor:
    """Attention of one layer. cache_kv: (k, v) [B, Smax, kv, dh] of this
    layer, written in place at `pos0` (= positions[0], known on the host)."""
    b, s, _ = h.shape
    nh, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    a = common.rms_norm(h, lp["ln1"])
    q = (a @ lp["attn"]["wq"].to(a.dtype)).reshape(b, s, nh, dh)
    k = (a @ lp["attn"]["wk"].to(a.dtype)).reshape(b, s, nkv, dh)
    v = (a @ lp["attn"]["wv"].to(a.dtype)).reshape(b, s, nkv, dh)
    if cfg.qk_norm:
        q = common.rms_norm(q, lp["qnorm"])
        k = common.rms_norm(k, lp["knorm"])
    q = common.rope(q, positions, cfg.rope_theta)
    k = common.rope(k, positions, cfg.rope_theta)

    if cache_kv is None:
        out = common.attention(q, k, v, causal=True, window=window,
                               cap=cfg.attn_softcap)
    else:
        ck, cv = cache_kv
        ck[:, pos0:pos0 + s] = k.to(ck.dtype)
        cv[:, pos0:pos0 + s] = v.to(cv.dtype)
        out = common.attention(q, ck, cv, causal=True, window=window,
                               cap=cfg.attn_softcap, q_offset=pos0,
                               kv_len=kv_len)
    out = out.reshape(b, s, nh * dh)
    return out @ lp["attn"]["wo"].to(out.dtype)


def _ffn_block(cfg: TransformerConfig, lp: dict, h: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(FFN output, the layer's MoE aux loss: f32, 0 on a dense layer)."""
    b, s, d = h.shape
    m = common.rms_norm(h, lp["ln2"])
    if cfg.moe is not None:
        y, aux = moe_lib.moe_apply(lp["ffn"], m.reshape(b * s, d), cfg.moe)
        return y.reshape(b, s, d), aux
    w = lp["ffn"]
    g = m @ w["w1"].to(m.dtype)
    hh = g * torch.sigmoid(g) * (m @ w["w3"].to(m.dtype))     # jax.nn.silu
    return (hh @ w["w2"].to(m.dtype),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _window_of(cfg: TransformerConfig, is_global: bool) -> int | None:
    """A layer's attention window: None (global) on a global layer."""
    return None if is_global else cfg.local_window


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    # F.embedding, not an index: an index's CUDA gradient (index_put with
    # accumulate) is deterministic only in PyTorch's deterministic mode;
    # phase 6e of chip_smoke.py holds a resumed training run to the bits of
    # an uninterrupted one
    h = torch.nn.functional.embedding(tokens.long(), params["embed"]).to(cfg.adtype)
    if cfg.embed_scale:
        # the reference's python-float scale is weakly typed: it is rounded
        # to the activation dtype first
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
    return h


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (hidden [B, S, D], aux_loss: the f32 sum of the
    layers' MoE load-balance losses, 0 for a dense model)."""
    s = tokens.shape[1]
    h = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in _leaves(params))
    for lp, flag in zip(_all_layer_params(params, cfg.n_layers), cfg.is_global_layer()):
        args = (cfg, lp, h, _window_of(cfg, flag), positions)
        h, layer_aux = (checkpoint(_layer, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                        if remat else _layer(*args))
        aux = aux + layer_aux
    h = common.rms_norm(h, params["final_norm"])
    return h, aux


def _layer(cfg: TransformerConfig, lp: dict, h: torch.Tensor, window: int | None,
           positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer of `forward`: (the residual stream after it, its aux loss)."""
    h = h + _attention_block(cfg, lp, h, window, positions=positions)
    ffn, aux = _ffn_block(cfg, lp, h)
    return h + ffn, aux


def unembed_matrix(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig):
    """batch: tokens [B, S] int32, labels [B, S] int32 (-100 ignored) ->
    (loss = xent + 0.01 * aux, {"xent", "aux"})."""
    hidden, aux = forward(params, batch["tokens"], cfg)
    xent = common.chunked_cross_entropy(
        hidden, unembed_matrix(params, cfg), batch["labels"],
        cap=cfg.final_softcap, chunk=min(cfg.xent_chunk, hidden.shape[1]))
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


# -----------------------------------------------------------------------------
# decode (serve_step)
# -----------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """An empty KV cache, on the card unless `device` names another."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=dev)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cur_len: int, cfg: TransformerConfig):
    """One serving step: tokens [B, 1] given a cache filled to cur_len.
    Returns (next-token logits [B, V] f32, the cache updated in place)."""
    cur_len = int(cur_len)
    h = _embed(params, tokens, cfg)
    positions = torch.full((1,), cur_len, dtype=torch.int32, device=h.device)
    for i, flag in enumerate(cfg.is_global_layer()):
        lp = layer_params(params, i)
        h = h + _attention_block(cfg, lp, h, _window_of(cfg, flag),
                                 positions=positions, pos0=cur_len,
                                 kv_len=cur_len + 1,
                                 cache_kv=(cache["k"][i], cache["v"][i]))
        h = h + _ffn_block(cfg, lp, h)[0]
    h = common.rms_norm(h, params["final_norm"])
    logits = h[:, 0, :] @ unembed_matrix(params, cfg).to(h.dtype)
    logits = common.softcap(logits.float(), cfg.final_softcap)
    return logits, cache
