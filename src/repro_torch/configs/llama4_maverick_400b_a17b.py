"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 [hf:meta-llama/Llama-4].

The transformer backbone only (the reference's vision frontend is a stub:
patch-embedding ids share the token embedding path). Pure full attention ->
long_500k skipped. Untied unembedding, no softcap; parameters stored in bf16
(1556 GB at 48 layers).
"""
from repro_torch.configs.registry import register_lm
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_expert=8192,
                  capacity_factor=1.25),
    rope_theta=500000.0, tie_embeddings=False,
    param_dtype="bfloat16",
    pure_full_attention=True,
)

SMOKE = TransformerConfig(
    name="llama4-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=1, d_expert=64, capacity_factor=2.0),
    tie_embeddings=False, pure_full_attention=True,
)

register_lm("llama4-maverick-400b-a17b", CONFIG, n_micro=4,
            optimizer="adamw", grad_accum_dtype="bfloat16", smoke_cfg=SMOKE)
