"""Port parity: the MoE MLP (`repro_torch.models.moe`) against `repro`.

``moe_apply`` on the same seeded bf16 inputs and weights in both
packages, for the ``silu_glu`` experts (mixtral, qwen3-moe, jamba) and
the ``sq_relu`` ones: the routing compared expert for expert (a flip
allowed only below ``ROUTE_EPS``, torch_lm_common), the outputs of the
tokens routed alike within 2e-2 of the largest output, the aux loss
within 1e-3 relative, every gradient (router, experts, input) within
3e-2 relative Frobenius; the capacity, the drops and their slots bit for
bit on the reference's own top-k; the lower expert first on a tie; the
chunked dispatch (``MOE_CHUNK_TOKENS`` set low in both packages).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import holder
from torch_lm_common import (BF16_TOL, configs, f32, rel_fro,
                             _routing_of_reference, routing_diff)

AUX_TOL, GRAD_TOL = 1e-3, 3e-2


def moe_case(act="silu_glu", seed=0, **moe):
    """(reference cfg, port cfg, reference params, port holder)."""
    jcfg, tcfg = configs("mixtral-8x7b", act=act)
    if moe:
        kw = dict(n_experts=4, top_k=2, d_ff_expert=64, **moe)
        jcfg = dataclasses.replace(jcfg, moe=JMoE(**kw))
        tcfg = dataclasses.replace(tcfg, moe=MoEConfig(**kw))
    p = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    tp = holder(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jcfg, tcfg, p, tp


def inputs(cfg, b, s, seed=0):
    x = np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model))
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def run_both(jcfg, tcfg, p, tp, x):
    """Outputs, aux, gradients of sum(out^2) * 1e-3 + aux in both."""
    def jloss(pp, xx):
        out, aux = jmoe.moe_apply(jcfg, pp, xx)
        return jnp.sum(out.astype(jnp.float32) ** 2) * 1e-3 + aux, (out, aux)

    xj = jnp.asarray(x, jnp.bfloat16)
    (_, (jo, ja)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, xj)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    for q in tp.parameters():
        q.grad = None
    to, ta = tmoe.moe_apply(tcfg, tp, xt)
    (torch.sum(to.float() ** 2) * 1e-3 + ta).backward()
    grads = {k: (tp.get_parameter(k).grad.numpy(), np.asarray(jgp[k])) for k in p}
    grads["x"] = (f32(xt.grad), f32(jgx))
    return (f32(to), f32(jo)), (float(ta), float(ja)), grads


def routing_both(jcfg, tcfg, p, tp, x):
    xt = x.reshape(-1, jcfg.d_model)
    ref = tuple(np.asarray(a) for a in _routing_of_reference(
        jcfg, p, jnp.asarray(xt, jnp.bfloat16)))
    with torch.no_grad():
        probs, _, tope = tmoe.route(tcfg, tp, torch.from_numpy(xt).bfloat16())
        _, keep = tmoe.slots(tcfg, tope, tmoe.capacity(tcfg, len(xt)))
    return ref, (probs.numpy(), tope.numpy(), keep.reshape(tope.shape).numpy())


CASES = [("silu_glu", 2, 48), ("silu_glu", 4, 64), ("silu_glu", 1, 7),
         ("silu_glu", 4, 1), ("sq_relu", 2, 48), ("sq_relu", 8, 32)]


@pytest.mark.parametrize("act,b,s", CASES)
def test_moe_apply_matches_reference(act, b, s):
    jcfg, tcfg, p, tp = moe_case(act, seed=b + s)
    x = inputs(jcfg, b, s, seed=s)
    ref, port = routing_both(jcfg, tcfg, p, tp, x)
    diff, flips, bad = routing_diff(ref, port)
    print(f"{act} [{b}, {s}]: {len(flips)} flips {flips}")
    assert not bad, bad
    (to, jo), (ta, ja), grads = run_both(jcfg, tcfg, p, tp, x)
    same = ~diff.reshape(b, s)
    assert to.shape == jo.shape == x.shape
    assert np.abs(to - jo)[same].max() <= BF16_TOL * np.abs(jo).max()
    assert abs(ta - ja) <= AUX_TOL * abs(ja)
    if not diff.any():
        errs = {k: rel_fro(*g) for k, g in grads.items()}
        assert max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("t", [1, 2, 3, 4, 7, 8, 31, 96, 100, 512, 4096, 8192])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
def test_capacity_is_the_references(arch, t):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    m = cfg.moe
    want = max(int(np.ceil(t / m.n_experts * m.capacity_factor * m.top_k)),
               m.top_k)
    assert tmoe.capacity(cfg, t) == want


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.25])
def test_drops_and_slots_bit_for_bit(cf):
    """On the reference's own top-k, the port's capacity positions, keep
    flags and dispatch rows are the reference's; a small capacity factor
    drops many tokens, and the outputs of dropped choices are zero in
    both."""
    jcfg, tcfg, p, tp = moe_case(seed=3, capacity_factor=cf)
    b, s = 4, 32
    x = inputs(jcfg, b, s, seed=5)
    xt = jnp.asarray(x.reshape(-1, jcfg.d_model), jnp.bfloat16)
    _, rtope, rkeep = _routing_of_reference(jcfg, p, xt)
    t, k = rtope.shape
    cap = tmoe.capacity(tcfg, t)
    flat = rtope.reshape(-1)
    onehot = jax.nn.one_hot(flat, jcfg.moe.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    want_slot = np.asarray(jnp.where(pos < cap, flat * cap + pos,
                                     jcfg.moe.n_experts * cap))
    slot, keep = tmoe.slots(tcfg, torch.from_numpy(np.asarray(rtope)).long(), cap)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep).reshape(-1))
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    dropped = int((~keep).sum())
    print(f"capacity factor {cf}: cap {cap}, {dropped} of {t * k} choices dropped")
    if cf < 1:
        assert dropped > 0
    ref, port = routing_both(jcfg, tcfg, p, tp, x)
    diff, _, bad = routing_diff(ref, port)
    assert not bad, bad
    (to, jo), (ta, ja), _ = run_both(jcfg, tcfg, p, tp, x)
    same = ~diff.reshape(b, s)
    assert np.abs(to - jo)[same].max() <= BF16_TOL * np.abs(jo).max()
    assert abs(ta - ja) <= AUX_TOL * abs(ja)
    # a token whose every choice is dropped gets a zero row in both
    none = ~np.asarray(rkeep).any(1).reshape(b, s)
    assert not np.any(jo[none]) and not np.any(to[none & same])


def test_ties_pick_the_lower_expert_first():
    """Duplicate router columns tie exactly: ``lax.top_k`` takes the lower
    expert index first, and so does the port's stable sort."""
    jcfg, tcfg, p, tp = moe_case(seed=4)
    r = np.array(p["router"])
    r[:, 3] = r[:, 1]  # experts 1 and 3 tie for every token
    r[:, 2] = r[:, 0]
    p = dict(p, router=jnp.asarray(r))
    tp = holder(**{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    x = inputs(jcfg, 2, 16, seed=6)
    ref, port = routing_both(jcfg, tcfg, p, tp, x)
    np.testing.assert_array_equal(port[1], ref[1])  # order within a token too
    assert set(ref[1][:, 0]) <= {0, 1}  # the lower of each tied pair first
    np.testing.assert_array_equal(ref[1][:, 1], ref[1][:, 0] + 2)


@pytest.mark.parametrize("act", ["silu_glu", "sq_relu"])
@pytest.mark.parametrize("b,s,chunks", [(4, 32, 8), (2, 48, 6), (1, 50, 1)])
def test_chunked_dispatch(act, b, s, chunks, monkeypatch):
    """``MOE_CHUNK_TOKENS`` = 16 in both packages: 128 tokens go in 8
    chunks of 16, 96 in 6; 50 tokens do not divide into 50 // 16 = 3, so
    one chunk.  The aux loss is the mean over chunks; the backward
    recomputes each."""
    monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", 16)
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", 16)
    jax.clear_caches()
    calls = []
    real = tmoe._moe_chunk
    monkeypatch.setattr(tmoe, "_moe_chunk",
                        lambda cfg, p, xt: calls.append(len(xt)) or real(cfg, p, xt))
    jcfg, tcfg, p, tp = moe_case(act, seed=7)
    x = inputs(jcfg, b, s, seed=8)
    (to, jo), (ta, ja), grads = run_both(jcfg, tcfg, p, tp, x)
    assert calls[:chunks] == [b * s // chunks] * chunks
    assert len(calls) == (2 * chunks if chunks > 1 else 1)  # recomputed
    diffs = []
    for xc in np.split(x.reshape(1, -1, jcfg.d_model), chunks, axis=1):
        ref, port = routing_both(jcfg, tcfg, p, tp, xc)
        diff, _, bad = routing_diff(ref, port)
        assert not bad, bad
        diffs.append(diff)
    same = ~np.concatenate(diffs).reshape(b, s)
    assert np.abs(to - jo)[same].max() <= BF16_TOL * np.abs(jo).max()
    assert abs(ta - ja) <= AUX_TOL * abs(ja)
    if same.all():
        errs = {k: rel_fro(*g) for k, g in grads.items()}
        assert max(errs.values()) <= GRAD_TOL, errs
    jax.clear_caches()
