"""Model code of the port: the decoder-only transformer's serving path
(`transformer.forward`, `transformer.decode_step`) on the hand-written
`flash_attention` kernel, with a dense or MoE FFN (`moe`: capacity dispatch,
expert parallelism over a `"model"` mesh); the recsys family (`recsys`:
DeepFM, BST, BERT4Rec, two-tower retrieval) on row-shardable embedding
tables (`embedding`), and the tiered two-tower retrieval
(`tiered_retrieval`); the E(n)-equivariant GNN (`egnn`) on the deterministic
segment-sum kernel, and its neighbour sampler (`sampler`)."""
from repro_torch.models import (common, egnn, embedding, moe, recsys,  # noqa: F401
                                 sampler, tiered_retrieval, transformer)

__all__ = ["common", "egnn", "embedding", "moe", "recsys", "sampler", "tiered_retrieval",
           "transformer"]
