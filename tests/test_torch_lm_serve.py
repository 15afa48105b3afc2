"""Port parity: LM serving (`repro_torch.train.serve`) against `repro`.

Decode is teacher-forced on the reference's own tokens (the prompt, then
its greedy continuation): at every step the port's logits are within
rtol/atol 2e-2 of the reference's (the reference's own bound,
tests/test_serving.py), with the bf16 cache and with the int8 one
(``KV_INT8``, monkeypatched in both packages).  Greedy tokens are equal
up to the first step where the reference's top-2 margin is at most
twice that tolerance; past a near-tie the two may rightly part.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.train import serve as jserve
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.train import serve as tserve
from torch_lm_common import (BF16_TOL, DENSE_ARCHS, configs, f32, jax_params,
                             torch_model)

STEPS, MAX_LEN = 10, 32


def close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_TOL, atol=BF16_TOL)


def prompt(cfg, b=2, s=5, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.fixture(params=[False, True], ids=["bf16_kv", "int8_kv"])
def kv_int8(request, monkeypatch):
    monkeypatch.setattr(jtr, "KV_INT8", request.param)
    monkeypatch.setattr(ttr, "KV_INT8", request.param)
    return request.param


def teacher_forced(jcfg, tcfg, jp, model, toks, max_len=MAX_LEN):
    """Both packages' logits at every position of ``toks`` [B, T]."""
    b = toks.shape[0]
    jst = jzoo.decode_state_init(jcfg, b, max_len)
    tst = tzoo.decode_state_init(tcfg, b, max_len, device="cpu")
    jdec, tdec = jserve.build_decode_step(jcfg), tserve.build_decode_step(tcfg)
    out = []
    for pos in range(toks.shape[1]):
        col = toks[:, pos: pos + 1]
        jl, jst = jdec(jp, jst, {"tokens": jnp.asarray(col)}, jnp.int32(pos))
        tl, tst = tdec(model, tst, {"tokens": torch.from_numpy(col)}, pos)
        out.append((f32(jl), f32(tl)))
    return out, tst


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_teacher_forced_and_greedy(arch, kv_int8):
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    p = prompt(jcfg)
    jout = np.asarray(jserve.greedy_generate(jcfg, jp, jnp.asarray(p),
                                             steps=STEPS, max_len=MAX_LEN))
    toks = np.concatenate([p, jout[:, 1:]], axis=1)
    steps, state = teacher_forced(jcfg, tcfg, jp, model, toks)
    for jl, tl in steps:
        assert tl.shape == (2, jcfg.padded_vocab)
        close(tl, jl)
    assert ("k_scale" in state["slot0"]) == kv_int8
    assert state["slot0"]["k"].dtype == (torch.int8 if kv_int8 else torch.bfloat16)
    # greedy: equal up to the first near-tie of the reference's logits
    tout = tserve.greedy_generate(tcfg, model, torch.from_numpy(p), steps=STEPS,
                                  max_len=MAX_LEN).numpy()
    assert tout.shape == jout.shape == (2, 1 + STEPS)
    assert (tout[:, 0] == p[:, 0]).all()
    gen_logits = np.stack([jl for jl, _ in steps[p.shape[1] - 1:]][:STEPS], 1)
    top2 = np.sort(gen_logits, axis=-1)[..., -2:]  # [B, STEPS, 2]
    tied = top2[..., 1] - top2[..., 0] <= 2 * BF16_TOL
    for row in range(p.shape[0]):
        n = int(np.argmax(tied[row])) if tied[row].any() else STEPS
        print(f"{arch} row {row}: greedy tokens compared on {n} of {STEPS} steps")
        np.testing.assert_array_equal(tout[row, 1: 1 + n], jout[row, 1: 1 + n])
    # the port's own loop: each generated token is the argmax of the port's
    # decode logits over its own sequence (positions, prompt feed, argmax)
    own = np.concatenate([p, tout[:, 1:]], axis=1)
    own_steps, _ = teacher_forced(jcfg, tcfg, jp, model, own)
    for i in range(STEPS):
        np.testing.assert_array_equal(
            own_steps[p.shape[1] - 1 + i][1].argmax(-1), tout[:, 1 + i])


def test_sliding_window_ring(kv_int8):
    """A window of 8 over a 20-token sequence: the cache is a ring of 8
    slots holding absolute positions."""
    jcfg, tcfg = configs("yi-6b", sliding_window=8)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    toks = prompt(jcfg, s=20, seed=2)
    steps, state = teacher_forced(jcfg, tcfg, jp, model, toks)
    for jl, tl in steps:
        close(tl, jl)
    assert state["slot0"]["k"].shape[2] == 8
    assert sorted(state["slot0"]["pos"][0].tolist()) == list(range(12, 20))


def test_cache_full_writes_last_slot():
    """Past ``max_len`` the reference writes the last slot again
    (``min(pos, s_max - 1)``); the port does the same."""
    jcfg, tcfg = configs("internlm2-1.8b")
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    steps, state = teacher_forced(jcfg, tcfg, jp, model, prompt(jcfg, s=12, seed=3),
                                  max_len=8)
    for jl, tl in steps:
        close(tl, jl)
    assert state["slot0"]["pos"][0].tolist() == list(range(7)) + [11]


def test_prefill_then_decode_consistent():
    """The port's prefill logits equal its step-by-step decode at the same
    position (as tests/test_serving.py holds the reference)."""
    jcfg, tcfg = configs("yi-6b")
    model = torch_model(tcfg, jax_params(jcfg))
    toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)
    pre = tserve.build_prefill_step(tcfg)(model, {"tokens": toks})
    st = tzoo.decode_state_init(tcfg, 1, 16, device="cpu")
    for p in range(4):
        lo, st = tzoo.decode_fn(tcfg, model, st, {"tokens": toks[:, p: p + 1]}, p)
    close(lo, pre)


def test_greedy_deterministic_and_int8_argmax(monkeypatch):
    """Two greedy runs agree; the int8 cache keeps the bf16 cache's argmax
    on the first steps (tests/test_serving.py, in the port)."""
    jcfg, tcfg = configs("internlm2-1.8b")
    model = torch_model(tcfg, jax_params(jcfg))
    p = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    out1 = tserve.greedy_generate(tcfg, model, p, steps=6, max_len=32)
    out2 = tserve.greedy_generate(tcfg, model, p, steps=6, max_len=32)
    assert out1.shape == (1, 7) and torch.equal(out1, out2)
    logits = {}
    for int8 in (False, True):
        monkeypatch.setattr(ttr, "KV_INT8", int8)
        st = tzoo.decode_state_init(tcfg, 2, 32, device="cpu")
        batch = {"tokens": torch.full((2, 1), 3, dtype=torch.int32)}
        logits[int8] = [f32(tzoo.decode_fn(tcfg, model, st, batch, pos)[0])
                        for pos in range(5)]
    for lo8, lo in zip(logits[True], logits[False]):
        assert np.abs(lo8 - lo).max() / (np.abs(lo).max() + 1e-9) < 0.05
        np.testing.assert_array_equal(lo8.argmax(-1), lo.argmax(-1))
