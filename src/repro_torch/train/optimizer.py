"""AdamW with optional bf16 moments + global-norm clipping + schedules.

Port of `repro.train.optimizer`.  Moments in bf16 halve the optimizer
state; the update math runs in fp32, with the reference's operation order
and its fp32 schedule, and rounds the moments to bf16 (round to nearest
even, as the reference's cast does).  Weight decay applies to every leaf,
norms and embeddings included.  ``params``, ``grads`` and the moments are
dicts of tensors keyed by parameter name; ``apply`` updates them in place
(where the reference donates its buffers).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"  # or "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: AdamWConfig, step) -> np.float32:
    """Linear warmup, then cosine down to 10% of ``lr``, in fp32."""
    f = np.float32
    step = f(step)
    warm = np.minimum(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((step - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return f(cfg.lr) * warm * (f(0.1) + f(0.9) * cos)


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def init(cfg: AdamWConfig, params: dict[str, torch.Tensor]) -> dict:
    mdt = _moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    return {"step": 0,
            "m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()}}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, opt_state, grads):
    """One AdamW step.  Returns (params, opt_state, metrics), all updated in
    place.  A missing gradient (a parameter the loss does not reach) counts
    as zero, as the reference's gradient tree has zeros there."""
    f = np.float32
    step = opt_state["step"] + 1
    grads = {k: grads[k] if grads.get(k) is not None else torch.zeros_like(p)
             for k, p in params.items()}
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = float(schedule(cfg, step))
    bc1 = float(f(1) - f(cfg.b1) ** f(step))
    bc2 = float(f(1) - f(cfg.b2) ** f(step))
    mdt = _moment_dtype(cfg)
    for k, p in params.items():
        g = grads[k].float() * scale
        m32 = cfg.b1 * opt_state["m"][k].float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * opt_state["v"][k].float() + (1 - cfg.b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        opt_state["m"][k].copy_(m32.to(mdt))
        opt_state["v"][k].copy_(v32.to(mdt))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gn, "lr": lr}
