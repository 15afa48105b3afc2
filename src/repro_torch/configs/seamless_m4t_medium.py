"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596; hf]
Audio frontend is a STUB: input_specs() provides precomputed frame
embeddings (assignment spec); 12 encoder + 12 decoder layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12,
    enc_layers=12,
    cross_attention=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    frontend="audio_stub",
    frontend_len=4096,
    rope_theta=10_000.0,
)
