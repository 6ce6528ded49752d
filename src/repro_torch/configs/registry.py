"""Architecture registry, the LM and recsys parts of
`repro.configs.registry`.

Each registered arch names its config, its cells, its serving functions and
its training setup (loss, optimizer, microbatches, gradient accumulation
dtype, and the `smoke` batch). A cell's dimensions are plain numbers: the
port runs on one device, so there are no PartitionSpecs. The LM family's
cells (`train_4k`, `prefill_32k`, `decode_32k`, `long_500k`) and the recsys
family's (`train_batch`, `serve_p99`, `serve_bulk`, `retrieval_cand`, and
two-tower's `retrieval_cand_tiered`) are ported; the GNN family (EGNN) is
not yet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import numpy as np
import torch

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass
class Cell:
    kind: str                       # train | prefill | decode | serve
    dims: dict[str, Any]            # input name -> shape tuple (or an int)


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                     # lm | recsys
    shapes: tuple[str, ...]
    skips: dict[str, str]
    config_for: Callable[[str], Any]
    cell_for: Callable[[str], Cell]
    serve_fn: Callable              # (cfg, shape) -> fn(params, batch)
    loss_fn: Callable | None = None     # (cfg) -> fn(params, batch)
    optimizer: str = "adamw"
    grad_accum_dtype: str = "float32"
    n_micro: int = 1                # train_4k microbatches
    smoke: Callable | None = None   # () -> (cfg, batch, kind)
    smoke_cfg: Any = None


ARCHS: dict[str, ArchSpec] = {}
_ARCH_MODULES = ["gemma2_2b", "gemma3_12b", "internlm2_1_8b", "kimi_k2_1t_a32b",
                 "llama4_maverick_400b_a17b", "bert4rec", "bst", "deepfm",
                 "two_tower_retrieval"]
_LOADED = False


def register(spec: ArchSpec) -> ArchSpec:
    ARCHS[spec.name] = spec
    return spec


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True


def get_arch(name: str) -> ArchSpec:
    _load_all()
    return ARCHS[name]


# =============================================================================
# LM family glue
# =============================================================================

def lm_cell(cfg, shape: str, n_micro: int = 1) -> Cell:
    """The registry's batch, length (and cache shape, or microbatches) of an
    LM cell."""
    if shape == "train_4k":
        return Cell("train", {"batch": 256, "seq_len": 4096, "n_micro": n_micro})
    if shape == "prefill_32k":
        return Cell("prefill", {"batch": 32, "seq_len": 32768})
    if shape in ("decode_32k", "long_500k"):
        b, s = (128, 32768) if shape == "decode_32k" else (1, 524288)
        return Cell("decode", {
            "batch": b, "seq_len": s,
            "cache": (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)})
    raise KeyError(shape)


def lm_loss(cfg):
    from repro_torch.models import transformer as T
    return lambda params, batch: T.loss_fn(params, batch, cfg)


def lm_serve(cfg, shape: str):
    """prefill_32k: last-token logits of `forward`, without the final softcap
    (as the reference's prefill returns them); the decode cells:
    `decode_step`, which applies it."""
    from repro_torch.models import transformer as T
    if shape == "prefill_32k":
        def prefill(params, batch):
            h, _ = T.forward(params, batch["tokens"], cfg)
            return h[:, -1, :] @ T.unembed_matrix(params, cfg).to(h.dtype)
        return prefill

    def decode(params, batch):
        return T.decode_step(params, batch["cache"], batch["tokens"],
                             batch["cur_len"], cfg)
    return decode


def register_lm(name: str, cfg, *, n_micro: int = 1, optimizer: str = "adamw",
                grad_accum_dtype: str = "float32", smoke_cfg=None) -> ArchSpec:
    skips = {}
    if cfg.pure_full_attention:
        skips["long_500k"] = ("pure full attention: 500k-token context is "
                              "quadratic at prefill; spec says skip "
                              "(DESIGN.md §Arch-applicability)")

    def smoke():
        """(the SMOKE config, a [2, 32] batch of the reference's numpy
        tokens as CPU int32 tensors with labels = tokens, "train")."""
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, smoke_cfg.vocab_size, (2, 32)).astype(np.int32))
        return smoke_cfg, {"tokens": toks, "labels": toks.clone()}, "train"

    return register(ArchSpec(
        name=name, family="lm", shapes=LM_SHAPES, skips=skips,
        config_for=lambda shape: cfg,
        cell_for=lambda shape: lm_cell(cfg, shape, n_micro),
        serve_fn=lm_serve, loss_fn=lm_loss, optimizer=optimizer,
        grad_accum_dtype=grad_accum_dtype, n_micro=n_micro, smoke=smoke,
        smoke_cfg=smoke_cfg))


# =============================================================================
# RecSys family glue
# =============================================================================

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_BATCH = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144}
N_CANDIDATES = 1_000_000


def recsys_kind(shape: str) -> str:
    return "train" if shape == "train_batch" else "serve"


def as_tensors(batch: dict) -> dict:
    """A smoke batch of numpy arrays as CPU tensors of the same dtypes."""
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def register_recsys(name: str, cfg, *, cell_for, loss_fn, serve_fn, smoke,
                    extra_shapes: tuple[str, ...] = ()) -> ArchSpec:
    return register(ArchSpec(
        name=name, family="recsys", shapes=RECSYS_SHAPES + extra_shapes, skips={},
        config_for=lambda shape: cfg, cell_for=cell_for, serve_fn=serve_fn,
        loss_fn=loss_fn, optimizer="adamw", smoke=smoke))
