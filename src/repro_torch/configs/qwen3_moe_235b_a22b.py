"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per-expert) vocab=151936, MoE 128e top-8.  [hf:Qwen/Qwen3-30B-A3B-family]
head_dim=128 (explicit, > d_model/n_heads), QK-norm omitted, qkv_bias off."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    moe_slots=(0,),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    act="silu_glu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)
