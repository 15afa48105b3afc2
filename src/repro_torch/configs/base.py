"""Model/shape configuration schema for the assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

LayerKind = Literal["attn", "mamba", "rwkv"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    # repeating layer pattern; len must divide n_layers.  e.g. jamba:
    # ("attn",) + ("mamba",)*7
    pattern: tuple[LayerKind, ...] = ("attn",)
    # which pattern slots use MoE MLPs (empty = all dense)
    moe_slots: tuple[int, ...] = ()
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    act: Literal["silu_glu", "sq_relu", "gelu"] = "silu_glu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # encoder-decoder (seamless): n_layers applies to the decoder
    enc_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: embeddings arrive precomputed (spec'd shapes)
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    frontend_len: int = 0  # encoder/prefix length fed by the stub
    frontend_dim: int | None = None  # stub embedding dim (defaults d_model)
    attn_logit_softcap: float | None = None
    parallel_block: bool = False  # command-r style parallel attn+mlp

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the embedding shards evenly over "model"
        (MaxText-style padding; extra rows are never targeted)."""
        return -(-self.vocab // 512) * 512

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (self.name, self.n_layers)
        return self.n_layers // len(self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is admissible (spec's long_500k rule)."""
        has_full_attn = "attn" in self.pattern and self.sliding_window is None
        return not has_full_attn or self.pattern.count("attn") < len(self.pattern)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test configuration of the same family (small dims, same pattern)."""
    small = dict(
        n_layers=len(cfg.pattern) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_ff=128,
        vocab=512,
        head_dim=16,
        frontend_len=min(cfg.frontend_len, 16) if cfg.frontend_len else 0,
        frontend_dim=32 if cfg.frontend_dim else None,
        enc_layers=2 if cfg.enc_layers else 0,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
        )
    if cfg.mamba is not None:
        small["mamba"] = MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16)
    if cfg.sliding_window:
        small["sliding_window"] = 32
    small.update(overrides)
    return replace(cfg, name=cfg.name + "-smoke", **small)
