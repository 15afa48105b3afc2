"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA.  [arXiv:2403.04652; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    act="silu_glu",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
)
