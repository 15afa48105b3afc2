"""Analytic roofline terms of the model zoo's cells, on H100 targets.

Port of the analytic half of `repro.launch.roofline`: an exact
component model of the port's architectures (matmul dims, attention
S², MoE capacity, SSM scans, remat ×2 forward, optimizer traffic),
reduced to per-device seconds:

    compute    = FLOPs / peak_flops    (dense bf16 peak per card)
    memory     = HBM bytes / hbm_bw
    collective = Σ link-bytes / link_bw  (per link, ring-weighted)

The device constants come from a `repro_torch.obs.roofline.DeviceSpec`
argument; the default is the bundled ``h100_sxm`` spec (989 TFLOP/s
bf16, 3.35 TB/s, NVLink 450 GB/s each way).  No TPU constant is kept.

``parse_collectives`` has no counterpart: it reads the collective
schedule from compiled XLA HLO text, which the port never produces (no
XLA compile; DTensor issues its collectives eagerly).  The port's
`obs/roofline.py` leaves ``predict_block_bt`` out for the same kind of
reason.  The dry run (`launch/dryrun.py`) records the analytic terms
only.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.roofline import DeviceSpec

# ------------------------------------------------------------- analytic ---

@dataclass
class Analytic:
    flops: float = 0.0  # global
    hbm_bytes: float = 0.0  # global
    coll_bytes: float = 0.0  # global payload over the slowest-link class
    notes: dict = field(default_factory=dict)


def param_count(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from the config."""
    d, hd = cfg.d_model, cfg.hd
    per_block_total = per_block_active = 0.0
    for slot, kind in enumerate(cfg.pattern):
        if kind == "attn":
            a = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            per_block_total += a
            per_block_active += a
        elif kind == "mamba":
            di = cfg.mamba.expand * d
            a = d * 2 * di + di * d + di * (cfg.mamba.d_state * 2 + d // 16) + \
                (d // 16) * di
            per_block_total += a
            per_block_active += a
        elif kind == "rwkv":
            a = 5 * d * d + d * d  # time-mix projections + output
            per_block_total += a
            per_block_active += a
        # mlp/moe
        if kind == "rwkv":
            m = d * cfg.d_ff * 2 + d * d
            per_block_total += m
            per_block_active += m
        elif cfg.moe is not None and slot in cfg.moe_slots:
            n_mats = 3 if cfg.act == "silu_glu" else 2
            per_block_total += cfg.moe.n_experts * n_mats * d * cfg.moe.d_ff_expert
            per_block_active += cfg.moe.top_k * n_mats * d * cfg.moe.d_ff_expert
        else:
            n_mats = 3 if cfg.act == "silu_glu" else 2
            per_block_total += n_mats * d * cfg.d_ff
            per_block_active += n_mats * d * cfg.d_ff
    total = per_block_total * cfg.n_blocks
    active = per_block_active * cfg.n_blocks
    if cfg.enc_layers:
        enc = cfg.enc_layers * (d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
                                + 2 * d * cfg.d_ff)
        xattn = cfg.n_layers * d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
        total += enc + xattn
        active += enc + xattn
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def train_analytic(cfg, shape, chips: int, *, microbatches: int = 1,
                   remat: bool = True) -> Analytic:
    """Global FLOPs/bytes/collectives for one train step."""
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    total, active = param_count(cfg)
    emb = cfg.padded_vocab * cfg.d_model
    matmul_params = active - emb * (1 if cfg.tie_embeddings else 2) * 0  # matmul path incl. head
    # matmul flops: fwd 2·N·D; bwd 4·N·D; remat refwd 2·N·D
    mult = (2 + 4 + (2 if remat else 0))
    flops = mult * matmul_params * tokens
    # attention scores: 2·S²·hd·H per layer fwd (causal halves it), ×(fwd+bwd+remat)
    n_attn = cfg.pattern.count("attn") * cfg.n_blocks + cfg.enc_layers + (
        cfg.n_layers if cfg.enc_layers else 0)
    win = min(cfg.sliding_window or S, S)
    score = 2 * 2 * B * S * win * cfg.n_heads * cfg.hd * 0.5
    flops += (3 + (1 if remat else 0)) * score * n_attn
    # lm head + loss
    flops += (2 + 4) * tokens * cfg.d_model * cfg.padded_vocab

    # HBM bytes (per step, global): weights traffic ×(fwd+bwd+remat refwd)
    # ×microbatches (FSDP regather per microbatch), bf16 compute copies.
    wbytes = total * 2 * (3 if remat else 2) * microbatches
    # optimizer: read p,m,v,g + write p,m,v (fp32 p/g, bf16 moments)
    obytes = total * (4 + 4 + 2 + 2) + total * (4 + 2 + 2)
    # activations: layer-boundary saves + recompute reads (bf16)
    act = cfg.n_layers * tokens * cfg.d_model * 2 * (4 if remat else 6)
    an = Analytic()
    an.flops = flops
    an.hbm_bytes = wbytes + obytes + act
    # collectives: FSDP all-gather params (bf16) fwd+bwd per microbatch +
    # grad reduce-scatter (fp32) + TP activation all-reduce 2/layer (bf16)
    fsdp = total * 2 * 2 * microbatches + total * 4
    tp_ar = 2 * cfg.n_layers * tokens * cfg.d_model * 2 * 2  # ring ≈ 2× payload
    an.coll_bytes = fsdp + tp_ar
    an.notes = {"params_total": total, "params_active": active,
                "model_flops_6nd": 6 * active * tokens}
    return an


def serve_analytic(cfg, shape, chips: int, *, prefill: bool) -> Analytic:
    B, S = shape.global_batch, shape.seq_len
    total, active = param_count(cfg)
    an = Analytic()
    if prefill:
        tokens = B * S
        an.flops = 2 * active * tokens
        n_attn = cfg.pattern.count("attn") * cfg.n_blocks + cfg.enc_layers + (
            cfg.n_layers if cfg.enc_layers else 0)
        win = min(cfg.sliding_window or S, S)
        an.flops += 2 * B * S * win * cfg.n_heads * cfg.hd * 0.5 * n_attn * 2
        an.hbm_bytes = total * 2 + tokens * cfg.d_model * 2 * cfg.n_layers * 2
        an.coll_bytes = total * 2 + 2 * cfg.n_layers * tokens * cfg.d_model * 2 * 2
        an.notes = {"model_flops_6nd": 2 * active * tokens}
        return an
    # decode: one token for the whole batch
    tokens = B
    an.flops = 2 * active * tokens
    # KV/state read is the decode bottleneck
    n_attn = cfg.pattern.count("attn") * cfg.n_blocks
    win = min(cfg.sliding_window or S, S)
    kv = n_attn * B * win * cfg.n_kv_heads * cfg.hd * 2 * 2
    state = 0.0
    if "mamba" in cfg.pattern:
        di = cfg.mamba.expand * cfg.d_model
        state += cfg.pattern.count("mamba") * cfg.n_blocks * B * di * \
            cfg.mamba.d_state * 4 * 2
    if "rwkv" in cfg.pattern:
        dh = cfg.d_model // cfg.n_heads
        state += cfg.n_layers * B * cfg.n_heads * dh * dh * 4 * 2
    an.flops += n_attn * 2 * B * win * cfg.n_heads * cfg.hd * 2
    an.hbm_bytes = total * 2 + kv + state
    an.coll_bytes = total * 2 * 0 + 2 * cfg.n_layers * B * cfg.d_model * 2 * 2
    an.notes = {"model_flops_6nd": 2 * active * tokens, "kv_bytes": kv + state}
    return an


def terms(flops, hbm, coll, chips: int, spec: DeviceSpec | None = None) -> dict:
    """Global quantities -> per-device roofline seconds on ``spec``
    (default ``h100_sxm``)."""
    spec = spec or DeviceSpec.load("h100_sxm")
    c = flops / chips / spec.peak_flops
    m = hbm / chips / spec.hbm_bw
    l = coll / chips / spec.link_bw
    dom = max(("compute", c), ("memory", m), ("collective", l), key=lambda t: t[1])
    return {
        "compute_s": c, "memory_s": m, "collective_s": l,
        "bottleneck": dom[0],
        "roofline_s": max(c, m, l),
        "mfu_bound": c / max(c, m, l, 1e-30),
    }
