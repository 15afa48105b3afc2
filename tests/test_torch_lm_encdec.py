"""Port parity: the encoder-decoder (`repro_torch.models.encdec`,
`attention.cross_attention`) against `repro`.

The reduced seamless-m4t-medium (the reference's init, perturbed,
carried by `models.convert`) on the same seeded frames and tokens:
cross attention (bf16 within 2e-2 of the largest output; fp32 within
1e-5), the encoder's memory and the decoder's hidden states (2e-2 of the
largest magnitude), and ``decode_step`` against the memory, one token at
a time, logits within rtol/atol 2e-2 and the cache rows written where
the reference's clamped ``dynamic_update_slice`` writes them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jed
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models.layers import holder
from torch_lm_common import (BF16_TOL, batch_np, configs, f32, jax_params,
                             torch_model)

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def case():
    jcfg, tcfg = configs(ARCH)
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, torch_model(tcfg, jp)


def scale_close(got, want, tol=BF16_TOL):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(jnp.bfloat16, BF16_TOL), (jnp.float32, 1e-5)])
@pytest.mark.parametrize("sq,sk", [(5, 24), (1, 24), (48, 600)])
def test_cross_attention(dtype, tol, sq, sk):
    """Queries from x, keys and values from the memory, no RoPE and no
    bias (the config's qkv bias is set and perturbed, and unused); one
    query, a few, and 48 queries against 600 memory rows."""
    jcfg, tcfg = configs(ARCH, qkv_bias=True)  # the bias is not applied
    p = jattn.attn_init(jcfg, jax.random.PRNGKey(sq + sk))
    rng = np.random.default_rng(sk)
    p = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         if k.startswith("b") else np.asarray(v) for k, v in p.items()}
    tp = holder(**{k: torch.from_numpy(v.copy()) for k, v in p.items()})
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (2, sq, jcfg.d_model)), dtype)
                   .astype(jnp.float32))
    mem = np.asarray(jnp.asarray(rng.normal(0, 1, (2, sk, jcfg.d_model)), dtype)
                     .astype(jnp.float32))
    mem_pos = jnp.broadcast_to(jnp.arange(sk, dtype=jnp.int32), (2, sk))
    want = jattn.cross_attention(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x, dtype), jnp.asarray(mem, dtype), mem_pos)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    with torch.no_grad():
        got = tattn.cross_attention(tcfg, tp, torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(mem).to(tdt))
    assert got.dtype == tdt
    scale_close(got, want, tol)


def test_encode_and_decode(case):
    jcfg, tcfg, jp, model = case
    b = batch_np(jcfg, 2, 40, seed=3)
    jmem = jed.encode(jcfg, jp, jnp.asarray(b["frames"]))
    with torch.no_grad():
        tmem = ted.encode(tcfg, model, torch.from_numpy(b["frames"]))
    assert tmem.dtype == torch.bfloat16 and tmem.shape == (2, 40, jcfg.d_model)
    scale_close(tmem, jmem)
    # the decoder on the reference's memory, so only the decoder differs
    mem = f32(jmem)
    jh = jed.decode(jcfg, jp, jnp.asarray(b["tokens"][:, :24]), jmem)
    with torch.no_grad():
        th = ted.decode(tcfg, model, torch.from_numpy(b["tokens"][:, :24]),
                        torch.from_numpy(mem).bfloat16())
    scale_close(th, jh)


def test_decode_state_init_is_the_references(case):
    jcfg, tcfg, _, _ = case
    want = jed.decode_state_init(jcfg, 3, 20)
    got = ted.decode_state_init(tcfg, 3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(f32(got[k]), f32(want[k]))


def test_decode_step_with_memory_and_a_full_cache(case):
    """12 tokens against a cache of 8: each step's logits against the
    reference's; past the cache the reference's dynamic_update_slice
    clamps the write to the last row, and so does the port."""
    jcfg, tcfg, jp, model = case
    b = batch_np(jcfg, 2, 16, seed=4)
    jmem = jed.encode(jcfg, jp, jnp.asarray(b["frames"]))
    tmem = torch.from_numpy(f32(jmem)).bfloat16()
    jst = jed.decode_state_init(jcfg, 2, 8)
    tst = ted.decode_state_init(tcfg, 2, 8, device="cpu")
    jstep = jax.jit(lambda p, s, t, pos, m: jed.decode_step(jcfg, p, s, t, pos, m))
    for pos in range(12):
        col = b["tokens"][:, pos: pos + 1]
        jl, jst = jstep(jp, jst, jnp.asarray(col), jnp.int32(pos), jmem)
        with torch.no_grad():
            tl, tst = ted.decode_step(tcfg, model, tst, torch.from_numpy(col), pos, tmem)
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=BF16_TOL, atol=BF16_TOL)
    assert tst["pos"][0].tolist() == list(range(7)) + [11]
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    scale_close(tst["k"], jst["k"])


def test_prefill_equals_step_by_step_decode(case):
    """The port's prefill logits equal its decode of the same tokens at the
    last position, on the same memory."""
    _, tcfg, _, model = case
    frames = torch.from_numpy(batch_np(tcfg, 1, 12, seed=6)["frames"])
    toks = torch.tensor([[5, 9, 2, 7, 11]], dtype=torch.int32)
    from repro_torch.models import model_zoo as tzoo

    pre = tzoo.prefill_fn(tcfg, model, {"tokens": toks, "frames": frames})
    with torch.no_grad():
        mem = ted.encode(tcfg, model, frames)
    st = tzoo.decode_state_init(tcfg, 1, 8, device="cpu")
    for p in range(5):
        lo, st = tzoo.decode_fn(tcfg, model, st, {"tokens": toks[:, p: p + 1],
                                                  "memory": mem}, p)
    np.testing.assert_allclose(f32(lo), f32(pre), rtol=BF16_TOL, atol=BF16_TOL)
