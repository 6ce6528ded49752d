"""bert4rec [recsys]: embed_dim=64 n_blocks=2 n_heads=2 seq_len=200,
bidirectional sequence encoder, masked-item objective [arXiv:1904.06690].
1M-item catalog; training uses sampled softmax (8192 shared negatives)."""
import numpy as np

from repro_torch.configs import registry as R
from repro_torch.models import recsys as M

CONFIG = M.Bert4RecConfig()
SMOKE = M.Bert4RecConfig(n_items=64, embed_dim=16, seq_len=12, n_blocks=1, n_heads=2,
                         n_negatives=16)


def _cell(shape: str) -> R.Cell:
    s = CONFIG.seq_len
    if shape == "train_batch":
        b = R.RECSYS_BATCH[shape]
        return R.Cell("train", {"seq": (b, s), "labels": (b, s),
                                "negatives": (CONFIG.n_negatives,)})
    if shape in ("serve_p99", "serve_bulk"):
        return R.Cell("serve", {"seq": (R.RECSYS_BATCH[shape], s)})
    return R.Cell("serve", {"seq": (1, s), "cand_ids": (R.N_CANDIDATES,)})


def _serve(cfg, shape):
    if shape == "retrieval_cand":
        return lambda p, b: M.bert4rec_serve_candidates(p, b, cfg)
    return lambda p, b: M.bert4rec_serve(p, b, cfg)


def _smoke():
    """(SMOKE, the reference's numpy batch as CPU tensors, "train"): two
    masked positions a row (the mask token 64), 16 shared negatives."""
    rng = np.random.default_rng(0)
    labels = np.full((8, 12), -100)
    labels[:, [2, 7]] = rng.integers(0, 64, (8, 2))
    seq = rng.integers(0, 64, (8, 12))
    seq[:, [2, 7]] = 64  # mask token
    batch = {"seq": seq.astype(np.int32), "labels": labels.astype(np.int32),
             "negatives": rng.integers(0, 64, 16).astype(np.int32)}
    return SMOKE, R.as_tensors(batch), "train"


R.register_recsys("bert4rec", CONFIG, cell_for=_cell,
                  loss_fn=lambda cfg: (lambda p, b: M.bert4rec_loss(p, b, cfg)),
                  serve_fn=_serve, smoke=_smoke)
