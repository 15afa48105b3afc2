"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + Qwen2-0.5B backbone.  [arXiv:2404.16821; hf]
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (256 tokens, InternViT-300M width 1024)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    act="silu_glu",
    norm="rmsnorm",
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vision_stub",
    frontend_len=256,
    frontend_dim=1024,
    rope_theta=1_000_000.0,
)
