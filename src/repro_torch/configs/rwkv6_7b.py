"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892; hf]  64 heads of 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    pattern=("rwkv",),
    act="sq_relu",
    norm="layernorm",
)
