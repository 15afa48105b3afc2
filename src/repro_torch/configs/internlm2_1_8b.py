"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA.  [arXiv:2403.17297; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    act="silu_glu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
)
