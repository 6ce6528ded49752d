"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA [arXiv:2403.17297].

Pure full attention -> long_500k skipped per spec. Untied unembedding, no
softcap.
"""
from repro_torch.configs.registry import register_lm
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="internlm2-1.8b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92544,
    rope_theta=1_000_000.0, tie_embeddings=False,
    pure_full_attention=True,
)

SMOKE = TransformerConfig(
    name="internlm2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512, tie_embeddings=False,
    pure_full_attention=True,
)

register_lm("internlm2-1.8b", CONFIG, n_micro=1, smoke_cfg=SMOKE)
