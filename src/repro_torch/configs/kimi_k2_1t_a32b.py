"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE [arXiv:2501.kimi2].

Pure full attention -> long_500k skipped per spec. Untied unembedding, no
softcap; parameters stored in bf16 (2084 GB at 61 layers). Optimizer:
Adafactor (bf16 Adam states for 1T params would not fit); train_4k uses
8-way grad accumulation in bf16.
"""
from repro_torch.configs.registry import register_lm
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  capacity_factor=1.25),
    rope_theta=50000.0, tie_embeddings=False,
    param_dtype="bfloat16",
    pure_full_attention=True,
)

SMOKE = TransformerConfig(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=2.0),
    tie_embeddings=False, pure_full_attention=True,
)

register_lm("kimi-k2-1t-a32b", CONFIG, n_micro=8, optimizer="adafactor",
            grad_accum_dtype="bfloat16", smoke_cfg=SMOKE)
