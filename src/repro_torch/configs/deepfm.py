"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247]. Criteo-scale tables: 39 fields x 1M rows."""
import numpy as np

from repro_torch.configs import registry as R
from repro_torch.models import recsys as M

CONFIG = M.DeepFMConfig()
SMOKE = M.DeepFMConfig(n_fields=6, vocab_per_field=50, embed_dim=8, mlp_dims=(32, 16))


def _cell(shape: str) -> R.Cell:
    if shape in R.RECSYS_BATCH:
        b = R.RECSYS_BATCH[shape]
        dims = {"feat_ids": (b, CONFIG.n_fields)}
        if shape == "train_batch":
            dims["labels"] = (b,)
        return R.Cell(R.recsys_kind(shape), dims)
    # retrieval_cand: 1 user context x 1M candidate items
    return R.Cell("serve", {"user_feat_ids": (1, CONFIG.n_fields - 1),
                            "cand_ids": (R.N_CANDIDATES,)})


def _serve(cfg, shape):
    if shape == "retrieval_cand":
        return lambda p, b: M.deepfm_serve_candidates(p, b, cfg)
    return lambda p, b: M.deepfm_serve(p, b, cfg)


def _smoke():
    """(SMOKE, the reference's numpy batch as CPU tensors, "train")."""
    rng = np.random.default_rng(0)
    batch = {"feat_ids": rng.integers(0, 50, (16, 6)).astype(np.int32),
             "labels": rng.integers(0, 2, 16).astype(np.float32)}
    return SMOKE, R.as_tensors(batch), "train"


R.register_recsys("deepfm", CONFIG, cell_for=_cell,
                  loss_fn=lambda cfg: (lambda p, b: M.deepfm_loss(p, b, cfg)),
                  serve_fn=_serve, smoke=_smoke)
