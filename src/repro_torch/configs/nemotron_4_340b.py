"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU (non-gated MLP).  [arXiv:2402.16819]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    act="sq_relu",
    norm="layernorm",
    rope_theta=10_000.0,
)
