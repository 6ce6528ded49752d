"""Architecture registry, the counterpart of `repro.configs.registry`.

Each registered arch names its config, its cells, its serving functions and
its training setup (loss, optimizer, microbatches, gradient accumulation
dtype, and the `smoke` batch). A cell's dimensions are plain numbers
(`cell_for(shape)`). The LM family's cells (`train_4k`, `prefill_32k`,
`decode_32k`, `long_500k`), the recsys family's (`train_batch`,
`serve_p99`, `serve_bulk`, `retrieval_cand`, and two-tower's
`retrieval_cand_tiered`), the GNN family's (EGNN's four graph shapes,
`GNN_SHAPES`) and the tiering family's (`configs/tiering_scsk.py`: the
paper's solver rounds and serving path) are ported.

For the dry run (`launch.dryrun`) each arch also gives its parameters as
meta tensors (`abstract_params`: the init function traced under
`FakeTensorMode`, nothing allocated), their PartitionSpecs (`param_specs`,
`distributed.sharding.P`) and each cell's inputs as meta tensors with their
specs on a mesh (`abstract_cell(shape, mesh)`, the reference's
`cell_for(shape, mesh)` inputs and input specs).
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
    kind: str                       # train | prefill | decode | serve | solve
    dims: dict[str, Any]            # input name -> shape tuple (or an int)


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str                     # lm | recsys | gnn | tiering
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
    abstract_params: Callable | None = None   # (cfg) -> tree of meta tensors
    param_specs: Callable | None = None       # (cfg) -> tree of P
    abstract_cell: Callable | None = None     # (shape, mesh) -> (inputs, specs)


ARCHS: dict[str, ArchSpec] = {}
_ARCH_MODULES = ["gemma2_2b", "gemma3_12b", "internlm2_1_8b", "kimi_k2_1t_a32b",
                 "llama4_maverick_400b_a17b", "bert4rec", "bst", "deepfm",
                 "two_tower_retrieval", "egnn", "tiering_scsk"]
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


def all_archs() -> dict[str, ArchSpec]:
    _load_all()
    return dict(ARCHS)


# =============================================================================
# abstract (meta) parameters and inputs, for the dry run
# =============================================================================

def abstract(init: Callable, cfg) -> dict:
    """`init(generator, cfg)`'s tree as meta tensors: its shapes and dtypes,
    traced under `FakeTensorMode` (nothing is drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.train import tree
    with FakeTensorMode():
        fake = init(torch.Generator(), cfg)
    return tree.map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), fake)


def meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def dims_cell(cell: Cell, mesh, *, f32: tuple[str, ...] = (),
              replicated: tuple[str, ...] = (), dim1: tuple[str, ...] = ()):
    """A cell's inputs as meta tensors (int32 but the names in `f32`) and
    their specs: the leading dimension over the data axes, but a one-row
    context ([1, ...]) and the names in `replicated` stay whole; the names
    in `dim1` are split over the data axes on their second dimension."""
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import data_axes
    dp = data_axes(mesh)
    inputs, specs = {}, {}
    for name, shape in cell.dims.items():
        inputs[name] = meta(shape, torch.float32 if name in f32 else torch.int32)
        rest = [None] * (len(shape) - 1)
        if name in dim1:
            specs[name] = P(None, dp, *rest[1:])
        elif name in replicated or shape[0] == 1:
            specs[name] = P(None, *rest)
        else:
            specs[name] = P(dp, *rest)
    return inputs, specs


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


def lm_abstract_cell(cfg, shape: str, mesh, n_micro: int = 1):
    """The reference's `lm_cell(cfg, shape, mesh, n_micro)` inputs as meta
    tensors, and their specs."""
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import data_axes
    dp = data_axes(mesh)
    dims = lm_cell(cfg, shape, n_micro).dims
    b, s = dims["batch"], dims["seq_len"]
    if shape == "train_4k":
        if n_micro > 1:
            tok, spec = meta((n_micro, b // n_micro, s)), P(None, dp, None)
        else:
            tok, spec = meta((b, s)), P(dp, None)
        return ({"tokens": tok, "labels": meta(tok.shape)},
                {"tokens": spec, "labels": spec})
    if shape == "prefill_32k":
        return {"tokens": meta((b, s))}, {"tokens": P(dp, None)}
    shard_seq = b == 1
    cspec = P(None, None, dp, None, "model") if shard_seq else \
        P(None, dp, None, None, "model")
    return ({"cache": {"k": meta(dims["cache"], cfg.adtype),
                       "v": meta(dims["cache"], cfg.adtype)},
             "tokens": meta((b, 1)), "cur_len": meta(())},
            {"cache": {"k": cspec, "v": cspec},
             "tokens": P(None, None) if shard_seq else P(dp, None),
             "cur_len": P()})


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

    from repro_torch.models import transformer as T
    return register(ArchSpec(
        name=name, family="lm", shapes=LM_SHAPES, skips=skips,
        config_for=lambda shape: cfg,
        cell_for=lambda shape: lm_cell(cfg, shape, n_micro),
        serve_fn=lm_serve, loss_fn=lm_loss, optimizer=optimizer,
        grad_accum_dtype=grad_accum_dtype, n_micro=n_micro, smoke=smoke,
        smoke_cfg=smoke_cfg,
        abstract_params=lambda c: abstract(T.init_params, c),
        param_specs=T.param_specs,
        abstract_cell=lambda shape, mesh: lm_abstract_cell(cfg, shape, mesh, n_micro)))


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
                    init, param_specs, f32_inputs: tuple[str, ...] = (),
                    extra_shapes: tuple[str, ...] = ()) -> ArchSpec:
    """A recsys arch; its cells' inputs are int32 ids but `f32_inputs`, the
    batch (or candidate) dimension over the data axes, as the reference's
    specs have them (`negatives` replicated)."""
    return register(ArchSpec(
        name=name, family="recsys", shapes=RECSYS_SHAPES + extra_shapes, skips={},
        config_for=lambda shape: cfg, cell_for=cell_for, serve_fn=serve_fn,
        loss_fn=loss_fn, optimizer="adamw", smoke=smoke,
        abstract_params=lambda c: abstract(init, c), param_specs=param_specs,
        abstract_cell=lambda shape, mesh: dims_cell(
            cell_for(shape), mesh, f32=f32_inputs, replicated=("negatives",))))


# =============================================================================
# GNN family glue (EGNN)
# =============================================================================

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

GNN_DIMS = {
    # nodes, edges (padded to a multiple of 512), d_feat, n_classes, task
    "full_graph_sm": (2708, 10752, 1433, 7, "node_class"),
    "minibatch_lg": (180224, 196608, 602, 41, "node_class"),
    "ogb_products": (2449029, 61859328, 100, 47, "node_class"),
    "molecule": (3840, 8192, 16, 1, "graph_reg"),
}


def gnn_cell(cfg, shape: str) -> Cell:
    """The shape's inputs: node_feat, coords, edges, and labels
    (node_class) or graph_ids with 128 targets (graph_reg)."""
    n, e, d, c, task = GNN_DIMS[shape]
    dims = {"node_feat": (n, d), "coords": (n, 3), "edges": (2, e)}
    if task == "node_class":
        dims["labels"] = (n,)
    else:
        dims["graph_ids"] = (n,)
        dims["targets"] = (128,)
    return Cell("train", dims)
