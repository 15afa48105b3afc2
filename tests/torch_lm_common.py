"""Shared inputs of the LM parity tests (tests/test_torch_lm_*.py,
tests/test_torch_ckpt.py).

The reference's parameters come from `repro.models.model_zoo.init` and
are perturbed from a seeded numpy generator (norm scales off one, biases
off zero), then carried into `repro_torch` by `models.convert`, so both
packages run the same weights.  Batches are seeded numpy arrays handed
to both.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
# MoE, hybrid Mamba, RWKV-6 and the encoder-decoder
ZOO_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
             "rwkv6-7b", "seamless-m4t-medium")
LM_ARCHS = DENSE_ARCHS + ZOO_ARCHS
# bf16 forward/prefill/decode logits: the reference's own bound
# (tests/test_serving.py)
BF16_TOL = 2e-2


def configs(arch: str, **over):
    """(reference cfg, port cfg) of the reduced configuration."""
    return (jax_reduced(jax_get_config(arch), **over),
            reduced(get_config(arch), **over))


def jax_params(jcfg, seed: int = 0):
    """The reference's init with its constant leaves perturbed: norm scales,
    Mamba's D and RWKV's ln_x off 1; biases, Mamba's conv and dt biases and
    RWKV's bonus u off 0; RWKV's token-shift mixes off 0.5."""
    params = jzoo.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        name = path[-1].key
        if name in ("scale", "D", "ln_x"):
            a = a * (1 + 0.1 * rng.standard_normal(a.shape))
        elif name in ("bias", "bq", "bk", "bv", "conv_b", "dt_bias", "u", "mu"):
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
    fd = cfg.frontend_dim or cfg.d_model
    if cfg.enc_layers > 0:
        out["frames"] = rng.normal(0, 0.02, (b, s, fd)).astype(np.float32)
    elif cfg.frontend == "vision_stub":
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


# ------------------------------------------------------- MoE routing ---
# A routing flip: the port and the reference pick different top-k experts
# for a token.  The router's input is the bf16 hidden state, which the
# two packages round differently at every op: on tokens whose routing
# agrees, their probabilities differ by up to 3e-3 (mixtral, qwen3-moe:
# two layers) and 2.5e-2 (jamba: MoE layers after up to 14 Mamba layers)
# at the reduced sizes.  A gap between the k-th and (k+1)-th probability
# moves by at most twice that, so a flip is allowed only where the
# reference's gap is below ROUTE_EPS.
ROUTE_EPS = 5e-2


def _routing_of_reference(cfg, p, xt):
    """The reference's routing lines of `repro.models.moe._moe_chunk`."""
    m = cfg.moe
    t = xt.shape[0]
    cap = max(int(np.ceil(t / m.n_experts * m.capacity_factor * m.top_k)),
              m.top_k)
    logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, tope = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(tope.reshape(-1), m.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return probs, tope, (pos < cap).reshape(t, m.top_k)


class RoutingRecorder:
    """Records every MoE dispatch group of both packages, in call order:
    ``ref`` (probs, top-k, keep) and ``port`` (probs, top-k, keep).
    Built with pytest's ``monkeypatch``; JAX's caches are cleared, so the
    reference is traced anew with the recording (call ``close`` after)."""

    def __init__(self, monkeypatch):
        from repro.models import moe as jmoe
        from repro_torch.models import moe as tmoe

        self.ref, self.port = [], []
        jchunk, tchunk = jmoe._moe_chunk, tmoe._moe_chunk

        def ref_chunk(cfg, p, xt, mesh):
            jax.debug.callback(
                lambda *a: self.ref.append(tuple(np.asarray(x) for x in a)),
                *_routing_of_reference(cfg, p, xt), ordered=True)
            return jchunk(cfg, p, xt, mesh)

        def port_chunk(cfg, p, xt):
            with torch.no_grad():
                probs, _, tope = tmoe.route(cfg, p, xt)
                _, keep = tmoe.slots(cfg, tope, tmoe.capacity(cfg, xt.shape[0]))
            self.port.append((probs.numpy(), tope.numpy(),
                              keep.reshape(tope.shape).numpy()))
            return tchunk(cfg, p, xt)

        jax.clear_caches()
        monkeypatch.setattr(jmoe, "_moe_chunk", ref_chunk)
        monkeypatch.setattr(tmoe, "_moe_chunk", port_chunk)

    def clear(self):
        self.ref.clear()
        self.port.clear()

    @staticmethod
    def close():
        jax.clear_caches()  # no later trace keeps the recording


def _experts(tope, keep, e):
    """[T, 2E] bool: each token's chosen experts, then its kept ones (the
    order among a token's k choices does not matter)."""
    rows = np.arange(len(tope))[:, None]
    out = np.zeros((len(tope), 2 * e), bool)
    out[rows, tope] = True
    out[rows, e + tope] = keep
    return out


def routing_diff(ref, port, eps: float = ROUTE_EPS):
    """One recorded dispatch group: (tokens whose experts or kept experts
    differ, flips [(token, gap)], bad [(token, gap)]).  A flip is a token
    whose chosen experts differ; it is bad when the reference's gap between
    its k-th and (k+1)-th probability is at least ``eps``.  A token whose
    choice agrees but whose kept experts differ is bad unless a token
    before it (token-major) chose differently: only that moves the
    capacity positions."""
    probs, rtope, rkeep = ref
    _, ptope, pkeep = port
    e, k = probs.shape[1], rtope.shape[1]
    rx, px = _experts(rtope, rkeep, e), _experts(ptope, pkeep, e)
    chose = (rx[:, :e] != px[:, :e]).any(1)
    kept = (rx[:, e:] != px[:, e:]).any(1)
    srt = np.sort(probs, axis=-1)[:, ::-1]
    gap = srt[:, k - 1] - srt[:, k] if e > k else np.full(len(srt), np.inf)
    flips = [(int(t), float(gap[t])) for t in np.flatnonzero(chose)]
    bad = [f for f in flips if f[1] >= eps]
    first = np.flatnonzero(chose)[0] if chose.any() else len(chose)
    bad += [(int(t), float("nan")) for t in np.flatnonzero(kept & ~chose)
            if t <= first]
    return chose | kept, flips, bad


def routing_taint(ref, port, b: int, s: int, eps: float = ROUTE_EPS):
    """Tokens [B, S] whose values may rightly differ between the packages
    after the recorded MoE groups (each over the B*S tokens, token-major,
    in layer order): a token whose experts differ, and every later token of
    its row (attention and the scans are causal).  Returns (taint, flips,
    bad): the flips and bad flips (``routing_diff``) at tokens not yet
    tainted, as (group, token, gap)."""
    taint = np.zeros((b, s), bool)
    flips, bad = [], []
    for call, (r, p) in enumerate(zip(ref, port)):
        diff, fl, bd = routing_diff(r, p, eps)
        clean = ~taint.reshape(-1)
        flips += [(call, t, g) for t, g in fl if clean[t]]
        bad += [(call, t, g) for t, g in bd if clean[t]]
        taint = np.maximum.accumulate(taint | diff.reshape(b, s), axis=1)
    return taint, flips, bad


# ------------------------------------------------- fp32 activations ---
# Two archs amplify the rounding difference of two bf16 implementations
# past the bf16 tolerances at the reduced size, while their logic agrees
# to ~1e-6 with fp32 activations:
# - jamba stacks 14 Mamba layers: its hidden states differ by 1.6%, 4.4%
#   and 12% of their largest magnitude at 2, 8 and 16 Mamba layers (no
#   MoE), and each package's error against a float64 run of one layer is
#   about the same (port 0.60-0.76%, reference 0.77-0.90%);
# - RWKV-6 normalises each head's WKV output over 16 channels after
#   rounding it to bf16 (ln_x): its prefill logits differ by up to 0.045
#   and single gradient leaves by up to 25% over seeds 1-3, with the loss
#   within 1.3e-3.
# Their whole-model values are held with the activations in fp32 in both
# packages (the Mamba scan inputs stay bf16, as both write them), at the
# stated tolerances; in bf16 their loss is held to LOSS_TOL, their prefill
# logits to BF16_TOL of the largest logit and jamba's routing to the flip
# rule (tests/test_torch_lm_model.py::test_bf16_as_shipped).
FP32_ARCHS = ("jamba-1.5-large-398b", "rwkv6-7b")


@contextlib.contextmanager
def fp32_activations():
    """``COMPUTE_DTYPE`` float32 in both packages' model modules; JAX's
    caches are cleared on entry and exit."""
    import importlib

    names = ("layers", "transformer", "encdec", "mamba", "rwkv6", "moe",
             "model_zoo", "attention")
    with pytest.MonkeyPatch.context() as mp:
        for pkg, dt in (("repro", jnp.float32), ("repro_torch", torch.float32)):
            for name in names:
                mod = importlib.import_module(f"{pkg}.models.{name}")
                if hasattr(mod, "COMPUTE_DTYPE"):
                    mp.setattr(mod, "COMPUTE_DTYPE", dt)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def decode_taint(ref, port, b: int, steps: int, eps: float = ROUTE_EPS):
    """The recorded MoE groups of ``steps`` decode steps (each step the
    same number of groups over the B tokens, in step order): taint [B,
    steps], a row tainted from the first step at which its experts differ
    (its cache and state then differ too), and the flips and bad flips of
    untainted rows as (group, row, gap)."""
    taint = np.zeros((b, steps), bool)
    flips, bad = [], []
    if not ref:
        return taint, flips, bad
    per = len(ref) // steps
    assert per * steps == len(ref) == len(port)
    row = np.zeros(b, bool)
    for step in range(steps):
        now = np.zeros(b, bool)
        for g in range(step * per, (step + 1) * per):
            diff, fl, bd = routing_diff(ref[g], port[g], eps)
            flips += [(g, t, gap) for t, gap in fl if not row[t]]
            bad += [(g, t, gap) for t, gap in bd if not row[t]]
            now |= diff
        row |= now
        taint[:, step] = row
    return taint, flips, bad
