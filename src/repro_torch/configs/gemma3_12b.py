"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global, 128k context, QK-norm [hf:google/gemma-3].

Hybrid local:global (5:1, window 1024) -> long_500k RUNS for this arch.
The reference's config, field for field: one rope_theta for every layer
and no softcap.
"""
from repro_torch.configs.registry import register_lm
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=15360, vocab_size=262144,
    local_window=1024, global_every=6, qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True, embed_scale=True,
    pure_full_attention=False,
)

SMOKE = TransformerConfig(
    name="gemma3-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512,
    local_window=8, global_every=3, qk_norm=True,
    tie_embeddings=True, embed_scale=True, pure_full_attention=False,
)

register_lm("gemma3-12b", CONFIG, n_micro=2, smoke_cfg=SMOKE)
