"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — Mamba+attn 1:7 interleave.  [arXiv:2403.19887]
Pattern: 8-layer Jamba block, attention at slot 4, MoE every other slot."""
from .base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe_slots=(1, 3, 5, 7),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    act="silu_glu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)
