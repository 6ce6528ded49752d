"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000 —
local+global alternating attention, logit softcaps [arXiv:2408.00118].

Hybrid local:global (1:1, window 4096) -> long_500k RUNS for this arch.
"""
from repro_torch.configs.registry import register_lm
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab_size=256000,
    local_window=4096, global_every=2,
    attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, embed_scale=True,
    pure_full_attention=False,
)

SMOKE = TransformerConfig(
    name="gemma2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=512,
    local_window=8, global_every=2, attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, embed_scale=True, pure_full_attention=False,
)

register_lm("gemma2-2b", CONFIG, n_micro=1, smoke_cfg=SMOKE)
