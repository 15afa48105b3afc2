"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA.  [arXiv:2401.04088; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    moe_slots=(0,),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    act="silu_glu",
    norm="rmsnorm",
    sliding_window=4096,
    rope_theta=1_000_000.0,
)
