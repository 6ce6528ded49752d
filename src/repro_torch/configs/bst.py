"""bst [recsys]: embed_dim=32 seq_len=20 n_blocks=1 n_heads=8
mlp=1024-512-256, transformer-seq interaction (Alibaba) [arXiv:1905.06874]."""
import numpy as np

from repro_torch.configs import registry as R
from repro_torch.models import recsys as M

CONFIG = M.BSTConfig()
SMOKE = M.BSTConfig(n_items=64, embed_dim=16, seq_len=5, n_heads=4, mlp_dims=(32, 16))


def _cell(shape: str) -> R.Cell:
    if shape in R.RECSYS_BATCH:
        b = R.RECSYS_BATCH[shape]
        dims = {"hist": (b, CONFIG.seq_len), "target": (b,)}
        if shape == "train_batch":
            dims["labels"] = (b,)
        return R.Cell(R.recsys_kind(shape), dims)
    return R.Cell("serve", {"hist": (1, CONFIG.seq_len), "cand_ids": (R.N_CANDIDATES,)})


def _serve(cfg, shape):
    if shape == "retrieval_cand":
        return lambda p, b: M.bst_serve_candidates(p, b, cfg)
    return lambda p, b: M.bst_serve(p, b, cfg)


def _smoke():
    """(SMOKE, the reference's numpy batch as CPU tensors, "train")."""
    rng = np.random.default_rng(0)
    batch = {"hist": rng.integers(0, 64, (8, 5)).astype(np.int32),
             "target": rng.integers(0, 64, 8).astype(np.int32),
             "labels": rng.integers(0, 2, 8).astype(np.float32)}
    return SMOKE, R.as_tensors(batch), "train"


R.register_recsys("bst", CONFIG, cell_for=_cell,
                  loss_fn=lambda cfg: (lambda p, b: M.bst_loss(p, b, cfg)),
                  serve_fn=_serve, smoke=_smoke)
