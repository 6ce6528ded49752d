"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot, sampled-softmax retrieval [RecSys'19 YouTube].

The arch the paper's technique integrates with first-class:
`retrieval_cand` has a tiered variant (`retrieval_cand_tiered`,
models/tiered_retrieval.py) whose Tier-1 candidates the SCSK solver
selects; its cell holds Tier-1 = N_CANDIDATES / 2 (budget_frac 0.5)."""
import numpy as np

from repro_torch.configs import registry as R
from repro_torch.models import recsys as M

CONFIG = M.TwoTowerConfig()
SMOKE = M.TwoTowerConfig(n_user_fields=3, n_item_fields=3, vocab_per_field=50,
                         field_dim=8, tower_dims=(32, 16), embed_dim=16)


def _cell(shape: str) -> R.Cell:
    fu, fi = CONFIG.n_user_fields, CONFIG.n_item_fields
    if shape in R.RECSYS_BATCH:
        b = R.RECSYS_BATCH[shape]
        dims = {"user_ids": (b, fu), "item_ids": (b, fi)}
        if shape == "train_batch":
            dims["item_logq"] = (b,)
        return R.Cell(R.recsys_kind(shape), dims)
    if shape == "retrieval_cand_tiered":
        n1 = R.N_CANDIDATES // 2
        return R.Cell("serve", {"user_ids": (1, fu), "tier1_emb": (n1, CONFIG.embed_dim),
                                "tier1_ids": (n1,)})
    return R.Cell("serve", {"user_ids": (1, fu),
                            "cand_emb": (R.N_CANDIDATES, CONFIG.embed_dim)})


def _serve(cfg, shape):
    if shape == "retrieval_cand":
        return lambda p, b: M.twotower_serve_candidates(p, b, cfg)
    if shape == "retrieval_cand_tiered":
        return lambda p, b: M.twotower_serve_candidates_tiered(p, b, cfg)
    return lambda p, b: M.twotower_serve(p, b, cfg)


def _smoke():
    """(SMOKE, the reference's numpy batch as CPU tensors, "train")."""
    rng = np.random.default_rng(0)
    batch = {"user_ids": rng.integers(0, 50, (8, 3)).astype(np.int32),
             "item_ids": rng.integers(0, 50, (8, 3)).astype(np.int32),
             "item_logq": np.zeros(8, np.float32)}
    return SMOKE, R.as_tensors(batch), "train"


R.register_recsys("two-tower-retrieval", CONFIG, cell_for=_cell,
                  loss_fn=lambda cfg: (lambda p, b: M.twotower_loss(p, b, cfg)),
                  serve_fn=_serve, smoke=_smoke, extra_shapes=("retrieval_cand_tiered",))
