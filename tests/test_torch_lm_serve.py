"""Port parity: LM serving (`repro_torch.train.serve`) against `repro`.

Decode is teacher-forced on the reference's own tokens (the prompt, then
its greedy continuation): at every step the port's logits are within
rtol/atol 2e-2 of the reference's (the reference's own bound,
tests/test_serving.py), with the bf16 cache and with the int8 one
(``KV_INT8``, monkeypatched in both packages).  Greedy tokens are equal
up to the first step where the reference's top-2 margin is at most
twice that tolerance; past a near-tie the two may rightly part.

Every LM arch: the decoder's attention, Mamba and RWKV states, the MoE
decode (B tokens a dispatch group; a row whose routing flips, below
``ROUTE_EPS``, is compared only before that step, as
``torch_lm_common.decode_taint`` rules), the FP32_ARCHS with fp32
activations (torch_lm_common), and the encoder-decoder through
``decode_fn`` against the reference's encoder memory, greedy by an
argmax loop in both packages (neither ``greedy_generate`` serves it).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro.train import serve as jserve
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.train import serve as tserve
from torch_lm_common import (BF16_TOL, FP32_ARCHS, LM_ARCHS, RoutingRecorder,
                             batch_np, configs, decode_taint, f32,
                             fp32_activations, jax_params, torch_model)

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


def teacher_forced(jcfg, tcfg, jp, model, toks, max_len=MAX_LEN, memory=None):
    """Both packages' logits at every position of ``toks`` [B, T]; the
    encoder-decoder cross-attends ``memory`` (numpy fp32 of bf16 values)."""
    b = toks.shape[0]
    jst = jzoo.decode_state_init(jcfg, b, max_len)
    tst = tzoo.decode_state_init(tcfg, b, max_len, device="cpu")
    jdec, tdec = ref_decode(jcfg), tserve.build_decode_step(tcfg)
    jmem, tmem = {}, {}
    if memory is not None:
        jmem = {"memory": jnp.asarray(memory, jed.COMPUTE_DTYPE)}
        tmem = {"memory": torch.from_numpy(memory).to(ttr.COMPUTE_DTYPE)}
    out = []
    for pos in range(toks.shape[1]):
        col = toks[:, pos: pos + 1]
        jl, jst = jdec(jp, jst, {"tokens": jnp.asarray(col), **jmem},
                       jnp.int32(pos))
        tl, tst = tdec(model, tst, {"tokens": torch.from_numpy(col), **tmem}, pos)
        out.append((f32(jl), f32(tl)))
    return out, tst


def ref_decode(jcfg):
    """The reference's decode step; jitted here for the encoder-decoder,
    whose ``decode_step`` is not (the decoder's is)."""
    step = jserve.build_decode_step(jcfg)
    return jax.jit(step) if jcfg.enc_layers else step


def encdec_greedy(decode, params, state_init, p, memory, to_arr, steps=STEPS):
    """Greedy tokens of the encoder-decoder through ``decode_fn``: the
    prompt fed a token at a time, then ``steps`` argmax tokens (as
    ``greedy_generate`` does for a decoder)."""
    b, s0 = p.shape
    st, out, tok = state_init(), [p[:, :1]], p[:, :1]
    for pos in range(s0 + steps - 1):
        tok = p[:, pos: pos + 1] if pos < s0 else tok
        lo, st = decode(params, st, {"tokens": to_arr(tok), "memory": memory}, pos)
        if pos >= s0 - 1:
            tok = np.asarray(f32(lo)).argmax(-1)[:, None].astype(np.int32)
            out.append(tok)
    return np.concatenate(out, axis=1)


def greedy_both(jcfg, tcfg, jp, model, p):
    """(reference greedy tokens, port greedy tokens, encoder memory or None)."""
    if not jcfg.enc_layers:
        jout = np.asarray(jserve.greedy_generate(jcfg, jp, jnp.asarray(p),
                                                 steps=STEPS, max_len=MAX_LEN))
        tout = tserve.greedy_generate(tcfg, model, torch.from_numpy(p),
                                      steps=STEPS, max_len=MAX_LEN).numpy()
        return jout, tout, None
    frames = batch_np(jcfg, p.shape[0], 24, seed=7)["frames"]
    memory = f32(jed.encode(jcfg, jp, jnp.asarray(frames)))
    jout = encdec_greedy(
        ref_decode(jcfg), jp,
        lambda: jzoo.decode_state_init(jcfg, p.shape[0], MAX_LEN), p,
        jnp.asarray(memory, jed.COMPUTE_DTYPE), jnp.asarray)
    tout = encdec_greedy(
        tserve.build_decode_step(tcfg), model,
        lambda: tzoo.decode_state_init(tcfg, p.shape[0], MAX_LEN, device="cpu"),
        p, torch.from_numpy(memory).to(ttr.COMPUTE_DTYPE), torch.from_numpy)
    return jout, tout, memory


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_teacher_forced_and_greedy(arch, kv_int8, monkeypatch):
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    p = prompt(jcfg)
    with contextlib.ExitStack() as stack:
        if arch in FP32_ARCHS:
            stack.enter_context(fp32_activations())
        rec = RoutingRecorder(monkeypatch) if jcfg.moe else None
        if rec:
            stack.callback(rec.close)
        jout, tout, memory = greedy_both(jcfg, tcfg, jp, model, p)
        toks = np.concatenate([p, jout[:, 1:]], axis=1)
        if rec:
            rec.clear()
        steps, state = teacher_forced(jcfg, tcfg, jp, model, toks, memory=memory)
        taint, flips, bad = decode_taint(rec.ref, rec.port, 2, len(steps)) \
            if rec else (np.zeros((2, len(steps)), bool), [], [])
        print(f"{arch}: {len(flips)} routing flips (group, row, gap) {flips}")
        assert not bad, bad
        for i, (jl, tl) in enumerate(steps):
            assert tl.shape == (2, jcfg.padded_vocab)
            close(tl[~taint[:, i]], jl[~taint[:, i]])
        attn = [f"slot{i}" for i, k in enumerate(jcfg.pattern) if k == "attn"]
        if jcfg.enc_layers:
            assert state["k"].dtype == ttr.COMPUTE_DTYPE  # no int8 branch
        for slot in attn[:1] if not jcfg.enc_layers else []:
            assert ("k_scale" in state[slot]) == kv_int8
            assert state[slot]["k"].dtype == (torch.int8 if kv_int8
                                              else ttr.COMPUTE_DTYPE)
        # greedy: equal up to the first near-tie of the reference's logits
        # or the first step a row's routing flips
        assert tout.shape == jout.shape == (2, 1 + STEPS)
        assert (tout[:, 0] == p[:, 0]).all()
        first = p.shape[1] - 1
        gen_logits = np.stack([jl for jl, _ in steps[first:]][:STEPS], 1)
        top2 = np.sort(gen_logits, axis=-1)[..., -2:]  # [B, STEPS, 2]
        tied = (top2[..., 1] - top2[..., 0] <= 2 * BF16_TOL) | \
            taint[:, first: first + STEPS]
        for row in range(p.shape[0]):
            n = int(np.argmax(tied[row])) if tied[row].any() else STEPS
            print(f"{arch} row {row}: greedy tokens compared on {n} of {STEPS} steps")
            np.testing.assert_array_equal(tout[row, 1: 1 + n], jout[row, 1: 1 + n])
        # the port's own loop: each generated token is the argmax of the
        # port's decode logits over its own sequence (positions, prompt
        # feed, argmax)
        own = np.concatenate([p, tout[:, 1:]], axis=1)
        own_steps, _ = teacher_forced(jcfg, tcfg, jp, model, own, memory=memory)
        for i in range(STEPS):
            np.testing.assert_array_equal(
                own_steps[first + i][1].argmax(-1), tout[:, 1 + i])


@pytest.mark.parametrize("arch,window,s", [("yi-6b", 8, 20), ("mixtral-8x7b", 32, 40)])
def test_sliding_window_ring(kv_int8, arch, window, s, monkeypatch):
    """A window over a longer sequence: the cache is a ring of ``window``
    slots holding absolute positions; mixtral's own reduced window (32),
    with its MoE decode (a row is compared before its first routing flip,
    as ``decode_taint`` rules)."""
    over = {} if arch == "mixtral-8x7b" else {"sliding_window": window}
    jcfg, tcfg = configs(arch, **over)
    assert jcfg.sliding_window == window
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    toks = prompt(jcfg, s=s, seed=2)
    rec = RoutingRecorder(monkeypatch) if jcfg.moe else None
    try:
        steps, state = teacher_forced(jcfg, tcfg, jp, model, toks, max_len=s)
    finally:
        if rec:
            rec.close()
    taint, flips, bad = decode_taint(rec.ref, rec.port, 2, s) if rec else (
        np.zeros((2, s), bool), [], [])
    assert not bad, bad
    for i, (jl, tl) in enumerate(steps):
        close(tl[~taint[:, i]], jl[~taint[:, i]])
    assert state["slot0"]["k"].shape[2] == window
    assert sorted(state["slot0"]["pos"][0].tolist()) == list(range(s - window, s))


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
