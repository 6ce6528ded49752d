"""RecSys architectures, the counterparts of `repro.models.recsys`: DeepFM,
BST, BERT4Rec and two-tower retrieval.

Each model has its Config, `*_init(gen, cfg)`, `*_loss`, `*_serve` and
`*_serve_candidates`, with the reference's names. Initialisers draw on an
explicit `torch.Generator` on its device, with the reference's
distributions and scales, not its numbers (`convert.recsys_params_from_numpy`
carries the reference's numbers across for the tests). Embedding tables
go through `embedding.lookup` (row-sharded under a `"model"` mesh); the
large-vocabulary softmaxes are in-batch (two-tower, with logQ correction)
or sampled (BERT4Rec). The transformer blocks of BST and BERT4Rec attend
non-causally through `common.attention`: on the card their forward takes
the one-pass short kernel `csrc/flash_attention_short.cu` (BST's head dim
32 / 8 = 4 read in place on its CUDA-core route, BERT4Rec's D 32 on its
TF32 tensor-core route; any batch one launch) and, under autograd, the
gradient the short backward `csrc/flash_backward_short.cu`. Every top-k is
`common.top_k`, in `jax.lax.top_k`'s order.

Scoring one query against many candidates is independent per candidate
(per row for BERT4Rec's catalog), so `bst_serve_candidates` and
`bert4rec_serve` work in chunks of rows to bound their transients; the
result is the unchunked function's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import mesh_context
from repro_torch.distributed.sharding import P
from repro_torch.models import common, embedding

CANDIDATE_CHUNK = 65535   # BST's candidates scored at a time: one attention launch each


def _normal(gen: torch.Generator, shape: tuple[int, ...], std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(softplus(x) - y x), softplus as log(1 + e^x) = logaddexp(x, 0)."""
    x = logits.float()
    return torch.mean(torch.logaddexp(x, torch.zeros_like(x)) - labels.float() * x)


# =============================================================================
# DeepFM (arXiv:1703.04247)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return self.n_fields * self.vocab_per_field


def deepfm_init(gen: torch.Generator, cfg: DeepFMConfig) -> dict:
    return {
        "emb": _normal(gen, (cfg.total_vocab, cfg.embed_dim), 0.01),
        "lin": _normal(gen, (cfg.total_vocab, 1), 0.01),
        "mlp": common.mlp_params(gen, (cfg.n_fields * cfg.embed_dim,) + cfg.mlp_dims + (1,)),
        "bias": torch.zeros((), device=gen.device),
    }


def deepfm_specs(cfg: DeepFMConfig) -> dict:
    """PartitionSpecs of `deepfm_init`'s tree: the tables row-sharded over
    `"model"` (`embedding.table_spec`), the rest replicated."""
    return {
        "emb": embedding.table_spec(),
        "lin": embedding.table_spec(),
        "mlp": _mlp_specs(len(cfg.mlp_dims) + 1),
        "bias": P(),
    }


def _mlp_specs(n: int) -> list[dict]:
    return [{"w": P(None, None), "b": P(None)} for _ in range(n)]


def _block_specs() -> dict:
    """A transformer block's specs: column-parallel wq/wk/wv/ff1,
    row-parallel wo/ff2 over `"model"`."""
    return {"wq": P(None, "model"), "wk": P(None, "model"),
            "wv": P(None, "model"), "wo": P("model", None),
            "ln1": P(None), "ln2": P(None),
            "ff1": P(None, "model"), "ff2": P("model", None)}


def _field_offsets(cfg: DeepFMConfig, device) -> torch.Tensor:
    return torch.arange(cfg.n_fields, dtype=torch.int32, device=device) * cfg.vocab_per_field


def deepfm_logits(params: dict, feat_ids: torch.Tensor, cfg: DeepFMConfig) -> torch.Tensor:
    """feat_ids [B, n_fields] (per-field local ids) -> [B]."""
    idx = feat_ids + _field_offsets(cfg, feat_ids.device)[None, :]
    v = embedding.lookup(params["emb"], idx)                    # [B, F, D]
    lin = embedding.lookup(params["lin"], idx)[..., 0]          # [B, F]
    # FM second order: ½((Σv)² − Σv²)
    s = v.sum(dim=1)
    fm2 = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)        # [B]
    deep = common.mlp(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return params["bias"] + lin.sum(dim=1) + fm2 + deep


def deepfm_loss(params: dict, batch: dict, cfg: DeepFMConfig):
    loss = _bce_with_logits(deepfm_logits(params, batch["feat_ids"], cfg), batch["labels"])
    return loss, {"bce": loss}


def deepfm_serve(params: dict, batch: dict, cfg: DeepFMConfig) -> torch.Tensor:
    return torch.sigmoid(deepfm_logits(params, batch["feat_ids"], cfg))


def deepfm_serve_candidates(params: dict, batch: dict, cfg: DeepFMConfig):
    """retrieval_cand: one user context x N candidate items. The candidate
    item id fills field 0; the user's fields 1..F-1 are broadcast."""
    cand = batch["cand_ids"]
    user = batch["user_feat_ids"].expand(cand.shape[0], batch["user_feat_ids"].shape[-1])
    scores = deepfm_logits(params, torch.cat([cand[:, None], user], dim=1), cfg)
    return common.top_k(scores, min(100, scores.shape[0]))


# =============================================================================
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 1_000_000
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    dtype: str = "float32"


def _tx_block_init(gen: torch.Generator, d: int, ff_mult: int = 4) -> dict:
    def zeros():
        return torch.zeros(d, device=gen.device)
    return {
        "wq": common.dense_init(gen, (d, d)),
        "wk": common.dense_init(gen, (d, d)),
        "wv": common.dense_init(gen, (d, d)),
        "wo": common.dense_init(gen, (d, d)),
        "ln1": zeros(), "ln2": zeros(),
        "ff1": common.dense_init(gen, (d, ff_mult * d)),
        "ff2": common.dense_init(gen, (ff_mult * d, d)),
    }


def _tx_block(bp: dict, h: torch.Tensor, n_heads: int) -> torch.Tensor:
    """A pre-norm encoder block: non-causal attention over the whole
    sequence, then a GELU FFN (the tanh approximation, `jax.nn.gelu`'s
    default)."""
    b, s, d = h.shape
    dh = d // n_heads
    a = common.rms_norm(h, bp["ln1"])
    q = (a @ bp["wq"].to(a.dtype)).reshape(b, s, n_heads, dh)
    k = (a @ bp["wk"].to(a.dtype)).reshape(b, s, n_heads, dh)
    v = (a @ bp["wv"].to(a.dtype)).reshape(b, s, n_heads, dh)
    out = common.attention(q, k, v, causal=False)
    h = h + out.reshape(b, s, d) @ bp["wo"].to(h.dtype)
    m = common.rms_norm(h, bp["ln2"])
    return h + F.gelu(m @ bp["ff1"].to(m.dtype), approximate="tanh") @ bp["ff2"].to(m.dtype)


def bst_init(gen: torch.Generator, cfg: BSTConfig) -> dict:
    d = cfg.embed_dim
    return {
        "item_emb": _normal(gen, (cfg.n_items, d), 0.01),
        "pos_emb": _normal(gen, (cfg.seq_len + 1, d), 0.01),
        "blocks": [_tx_block_init(gen, d) for _ in range(cfg.n_blocks)],
        "mlp": common.mlp_params(gen, ((cfg.seq_len + 1) * d,) + cfg.mlp_dims + (1,)),
    }


def bst_specs(cfg: BSTConfig) -> dict:
    return {
        "item_emb": embedding.table_spec(),
        "pos_emb": P(None, None),
        "blocks": [_block_specs() for _ in range(cfg.n_blocks)],
        "mlp": _mlp_specs(len(cfg.mlp_dims) + 1),
    }


def bst_logits(params: dict, hist: torch.Tensor, target: torch.Tensor,
               cfg: BSTConfig) -> torch.Tensor:
    """hist [B, L] item ids (-1 pad), target [B] item id -> [B]."""
    seq = torch.cat([hist.clamp(min=0), target[:, None]], dim=1)
    h = embedding.lookup(params["item_emb"], seq)               # [B, L+1, D]
    h = h + params["pos_emb"][None].to(h.dtype)
    for bp in params["blocks"]:
        h = _tx_block(bp, h, cfg.n_heads)
    return common.mlp(params["mlp"], h.reshape(h.shape[0], -1))[:, 0]


def bst_loss(params: dict, batch: dict, cfg: BSTConfig):
    loss = _bce_with_logits(bst_logits(params, batch["hist"], batch["target"], cfg),
                            batch["labels"])
    return loss, {"bce": loss}


def bst_serve(params: dict, batch: dict, cfg: BSTConfig) -> torch.Tensor:
    return torch.sigmoid(bst_logits(params, batch["hist"], batch["target"], cfg))


def bst_serve_candidates(params: dict, batch: dict, cfg: BSTConfig):
    """One user history x N candidate targets, CANDIDATE_CHUNK candidates
    at a time (a candidate's score needs only its own row)."""
    cand = batch["cand_ids"]
    hist = batch["hist"].expand(min(CANDIDATE_CHUNK, cand.shape[0]), batch["hist"].shape[-1])
    scores = torch.cat([bst_logits(params, hist[:c.shape[0]], c, cfg)
                        for c in cand.split(CANDIDATE_CHUNK)])
    return common.top_k(scores, min(100, cand.shape[0]))


# =============================================================================
# BERT4Rec (arXiv:1904.06690)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000          # +1 mask token appended
    embed_dim: int = 64
    seq_len: int = 200
    n_blocks: int = 2
    n_heads: int = 2
    n_negatives: int = 8192           # sampled softmax
    dtype: str = "float32"

    @property
    def table_rows(self) -> int:
        """The mask token (row n_items) and padding up to a multiple of 512,
        so that the row-sharded table divides any mesh."""
        return -(-(self.n_items + 1) // 512) * 512


def bert4rec_init(gen: torch.Generator, cfg: Bert4RecConfig) -> dict:
    d = cfg.embed_dim
    return {
        "item_emb": _normal(gen, (cfg.table_rows, d), 0.01),
        "pos_emb": _normal(gen, (cfg.seq_len, d), 0.01),
        "blocks": [_tx_block_init(gen, d) for _ in range(cfg.n_blocks)],
        "out_norm": torch.zeros(d, device=gen.device),
    }


def bert4rec_specs(cfg: Bert4RecConfig) -> dict:
    return {
        "item_emb": embedding.table_spec(),
        "pos_emb": P(None, None),
        "blocks": [_block_specs() for _ in range(cfg.n_blocks)],
        "out_norm": P(None),
    }


def bert4rec_encode(params: dict, seq: torch.Tensor, cfg: Bert4RecConfig) -> torch.Tensor:
    """seq [B, S] item ids (the mask token n_items, -1 pad) -> [B, S, D]."""
    h = embedding.lookup(params["item_emb"], seq.clamp(min=0))
    h = h + params["pos_emb"][None].to(h.dtype)
    for bp in params["blocks"]:
        h = _tx_block(bp, h, cfg.n_heads)
    return common.rms_norm(h, params["out_norm"])


def bert4rec_loss(params: dict, batch: dict, cfg: Bert4RecConfig):
    """Masked-item prediction with sampled softmax: seq [B, S] (mask token =
    n_items), labels [B, S] (-100 = not masked), negatives [K] item ids
    shared across the batch."""
    h = bert4rec_encode(params, batch["seq"], cfg)
    labels = batch["labels"]
    valid = labels >= 0
    pos_emb = embedding.lookup(params["item_emb"], labels.clamp(min=0))     # [B, S, D]
    neg_emb = embedding.lookup(params["item_emb"], batch["negatives"])     # [K, D]
    pos_logit = torch.sum(h * pos_emb, dim=-1, keepdim=True)                # [B, S, 1]
    neg_logit = torch.einsum("bsd,kd->bsk", h, neg_emb)
    logits = torch.cat([pos_logit, neg_logit], dim=-1).float()
    xent = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    loss = torch.sum(torch.where(valid, xent, torch.zeros_like(xent))) \
        / torch.clamp(valid.sum(), min=1)
    return loss, {"xent": loss}


def _catalog_top_k(h: torch.Tensor, emb: torch.Tensor, lo: int, n_items: int, k: int,
                   chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of h [B, D] against the table rows emb [V, D] whose global
    ids start at `lo`, rows past the catalog (the mask token and padding)
    at -inf; `chunk` rows of h at a time. Indices are global."""
    valid = torch.arange(lo, lo + emb.shape[0], device=emb.device) < n_items
    vals, ids = [], []
    for hc in h.split(chunk):
        sc = hc @ emb.T.to(hc.dtype)
        sc = torch.where(valid[None, :], sc, torch.tensor(float("-inf"), device=sc.device,
                                                          dtype=sc.dtype))
        v, i = common.top_k(sc, k)
        vals.append(v)
        ids.append(i + lo)
    return torch.cat(vals), torch.cat(ids)


def bert4rec_serve(params: dict, batch: dict, cfg: Bert4RecConfig, *,
                   naive: bool = False, k: int = 100, chunk: int = 2048):
    """Next-item top-k over the whole catalog from the last position.

    Under a `"model"` mesh each entry scores its own table rows, takes a
    local top-k in row chunks, and only the [B, R*k] candidates meet on the
    first entry (in rank order) for the final top-k: the [B, V] score
    matrix never leaves its shard. `naive` (or no such mesh) scores the
    whole table on one device, also `chunk` rows at a time."""
    h = bert4rec_encode(params, batch["seq"], cfg)[:, -1]      # [B, D]
    table = params["item_emb"]
    mesh = mesh_context.current_mesh()
    if naive or mesh_context.model_axis_in(mesh) is None:
        return _catalog_top_k(h, table, 0, cfg.n_items, k, chunk)
    n = mesh.size
    if table.shape[0] % n:
        raise ValueError(f"{table.shape[0]} table rows do not split over {n} entries")
    v_local = table.shape[0] // n
    parts = [_catalog_top_k(h.to(dev), table[r * v_local:(r + 1) * v_local].to(dev),
                            r * v_local, cfg.n_items, k, chunk)
             for r, dev in enumerate(mesh.devices)]
    first = mesh.devices[0]
    v_all = torch.stack([v.to(first) for v, _ in parts], dim=1).reshape(h.shape[0], -1)
    i_all = torch.stack([i.to(first) for _, i in parts], dim=1).reshape(h.shape[0], -1)
    vk, sel = common.top_k(v_all, k)
    return vk.to(h.device), torch.gather(i_all, 1, sel).to(h.device)


def bert4rec_serve_candidates(params: dict, batch: dict, cfg: Bert4RecConfig):
    h = bert4rec_encode(params, batch["seq"], cfg)[:, -1]      # [1, D]
    cand = embedding.lookup(params["item_emb"], batch["cand_ids"])
    scores = (cand @ h[0]).float()
    return common.top_k(scores, min(100, scores.shape[0]))


# =============================================================================
# Two-tower retrieval (YouTube RecSys'19-style, sampled softmax + logQ)
# =============================================================================

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_user_fields: int = 8
    n_item_fields: int = 8
    vocab_per_field: int = 1_000_000
    field_dim: int = 32
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    embed_dim: int = 256
    temperature: float = 0.05
    dtype: str = "float32"


def twotower_init(gen: torch.Generator, cfg: TwoTowerConfig) -> dict:
    du = cfg.n_user_fields * cfg.field_dim
    di = cfg.n_item_fields * cfg.field_dim
    return {
        "user_emb": _normal(gen, (cfg.n_user_fields * cfg.vocab_per_field, cfg.field_dim), 0.01),
        "item_emb": _normal(gen, (cfg.n_item_fields * cfg.vocab_per_field, cfg.field_dim), 0.01),
        "user_mlp": common.mlp_params(gen, (du,) + cfg.tower_dims),
        "item_mlp": common.mlp_params(gen, (di,) + cfg.tower_dims),
    }


def twotower_specs(cfg: TwoTowerConfig) -> dict:
    return {
        "user_emb": embedding.table_spec(),
        "item_emb": embedding.table_spec(),
        "user_mlp": _mlp_specs(len(cfg.tower_dims)),
        "item_mlp": _mlp_specs(len(cfg.tower_dims)),
    }


def _tower(emb_table: torch.Tensor, mlp: list, feat_ids: torch.Tensor, n_fields: int,
           vocab: int) -> torch.Tensor:
    """The tower's output, L2-normalised (the norm clamped at 1e-6)."""
    idx = feat_ids + (torch.arange(n_fields, dtype=torch.int32, device=feat_ids.device)
                      * vocab)[None, :]
    v = embedding.lookup(emb_table, idx)                        # [B, F, d]
    z = common.mlp(mlp, v.reshape(v.shape[0], -1))
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-6)


def twotower_user(params: dict, user_ids: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    return _tower(params["user_emb"], params["user_mlp"], user_ids,
                  cfg.n_user_fields, cfg.vocab_per_field)


def twotower_item(params: dict, item_ids: torch.Tensor, cfg: TwoTowerConfig) -> torch.Tensor:
    return _tower(params["item_emb"], params["item_mlp"], item_ids,
                  cfg.n_item_fields, cfg.vocab_per_field)


def twotower_loss(params: dict, batch: dict, cfg: TwoTowerConfig):
    """In-batch softmax over the [B, B] user x item scores with logQ
    correction: user_ids [B, Fu], item_ids [B, Fi], item_logq [B] (the log
    sampling probability of each in-batch item). The gold score is the
    diagonal (whose gradient is a copy, not a scatter)."""
    u = twotower_user(params, batch["user_ids"], cfg)           # [B, D]
    it = twotower_item(params, batch["item_ids"], cfg)          # [B, D]
    scores = (u @ it.T).float() / cfg.temperature
    scores = scores - batch["item_logq"][None, :]
    labels = torch.arange(scores.shape[0], device=scores.device)
    loss = torch.mean(torch.logsumexp(scores, dim=-1) - torch.diagonal(scores))
    acc = torch.mean((torch.argmax(scores, dim=-1) == labels).float())
    return loss, {"xent": loss, "in_batch_acc": acc}


def twotower_serve(params: dict, batch: dict, cfg: TwoTowerConfig) -> torch.Tensor:
    """Online scoring: the user x item pairwise dot (the p99 path)."""
    u = twotower_user(params, batch["user_ids"], cfg)
    it = twotower_item(params, batch["item_ids"], cfg)
    return torch.sum(u * it, dim=-1)


def twotower_serve_candidates(params: dict, batch: dict, cfg: TwoTowerConfig):
    """retrieval_cand: one user x N precomputed candidate embeddings [N, D]
    (the serving index, `twotower_item` over the catalog) -> top-k."""
    u = twotower_user(params, batch["user_ids"], cfg)           # [1, D]
    scores = (batch["cand_emb"] @ u[0]).float()
    return common.top_k(scores, min(100, scores.shape[0]))


def twotower_serve_candidates_tiered(params: dict, batch: dict, cfg: TwoTowerConfig):
    """The paper's technique in the retrieval hot path: a ψ^clause-eligible
    query scores only the Tier-1 slice of the index, `tier1_emb` [N1, D]
    with global ids `tier1_ids` [N1] (gathered when the tiering is built);
    Theorem 3.1 guarantees that no matching candidate is lost. Ineligible
    queries take `twotower_serve_candidates` over the whole index."""
    u = twotower_user(params, batch["user_ids"], cfg)           # [1, D]
    scores = (batch["tier1_emb"] @ u[0]).float()
    v, i = common.top_k(scores, min(100, scores.shape[0]))
    return v, batch["tier1_ids"][i]
