"""Shared inputs of the LM parity tests (tests/test_torch_lm_*.py,
tests/test_torch_ckpt.py).

The reference's parameters come from `repro.models.model_zoo.init` and
are perturbed from a seeded numpy generator (norm scales off one, biases
off zero), then carried into `repro_torch` by `models.convert`, so both
packages run the same weights.  Batches are seeded numpy arrays handed
to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.models import convert

# the dense decoder-only family: pattern ("attn",), no MoE, no encoder
DENSE_ARCHS = ("yi-6b", "internlm2-1.8b", "command-r-35b", "nemotron-4-340b",
               "internvl2-1b")
# bf16 forward/prefill/decode logits: the reference's own bound
# (tests/test_serving.py)
BF16_TOL = 2e-2


def configs(arch: str, **over):
    """(reference cfg, port cfg) of the reduced configuration."""
    return (jax_reduced(jax_get_config(arch), **over),
            reduced(get_config(arch), **over))


def jax_params(jcfg, seed: int = 0):
    """The reference's init, norm scales and biases perturbed off 1 and 0."""
    params = jzoo.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = path[-1].key
        if name == "scale":
            a = a * (1 + 0.1 * rng.standard_normal(a.shape))
        elif name in ("bias", "bq", "bk", "bv"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def torch_model(tcfg, jparams):
    return convert.params_from_jax(tcfg, np_tree(jparams), device="cpu")


def batch_np(cfg, b: int, s: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s))
    out = {"tokens": toks.astype(np.int32),
           "targets": np.roll(toks, -1, axis=1).astype(np.int32),
           "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        fd = cfg.frontend_dim or cfg.d_model
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (b, cfg.frontend_len, fd)).astype(np.float32)
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def torch_grads(model) -> dict:
    """The port's ``.grad`` in the reference's flat keys (blocks stacked)."""
    out, rows = {}, {}
    for name, p in model.named_parameters():
        key, blk = convert.jax_key(name)
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        if blk is None:
            out[key] = g
        else:
            rows.setdefault(key, {})[blk] = g
    for key, by_blk in rows.items():
        out[key] = np.stack([by_blk[b] for b in range(len(by_blk))])
    return out


def rel_fro(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))
