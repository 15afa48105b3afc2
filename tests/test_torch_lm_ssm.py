"""Port parity: the Mamba and RWKV-6 layers (`repro_torch.models.mamba`,
`rwkv6`) against `repro`.

Each layer's reference parameters (init, then the constant leaves
perturbed) run in both packages on the same seeded inputs: ``apply``
over whole sequences (several chunks, one chunk, a chunk of odd length),
in bf16 within 2e-2 of the largest output and, with fp32 inputs (the
layers follow the input dtype; the Mamba scan inputs stay bf16), within
1e-4; gradients within 3e-2 relative Frobenius in bf16.  Decode runs one
token at a time from zero states in both, and its output and the new
states (conv window, SSM state; token shifts, WKV state) are compared at
every step.  The lengths that the reference's chunk reshape rejects
raise in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmb
from repro.models import rwkv6 as jrk
from repro_torch.models import mamba as tmb
from repro_torch.models import rwkv6 as trk
from repro_torch.models.layers import holder
from torch_lm_common import BF16_TOL, configs, f32, rel_fro

GRAD_TOL, FP32_TOL = 3e-2, 1e-4
PERTURB = {"conv_b": 0.1, "dt_bias": 0.1, "u": 0.1, "mu": 0.1}  # added
SCALE = {"D": 0.1, "ln_x": 0.1}  # multiplied by 1 + this * N(0, 1)


def layer_params(init, cfg, seed):
    p = init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 50)
    out = {}
    for k, v in p.items():
        a = np.array(v, np.float32)
        if k in PERTURB:
            a = a + PERTURB[k] * rng.standard_normal(a.shape).astype(np.float32)
        if k in SCALE:
            a = a * (1 + SCALE[k] * rng.standard_normal(a.shape)).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(v) for k, v in out.items()},
            holder(**{k: torch.from_numpy(v.copy()) for k, v in out.items()}))


def inputs(cfg, b, L, seed, dtype=jnp.bfloat16):
    x = np.random.default_rng(seed).normal(0, 1, (b, L, cfg.d_model))
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


def close_scaled(got, want, tol=BF16_TOL):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------- Mamba ---

def mamba_case(seed=0, **over):
    jcfg, tcfg = configs("jamba-1.5-large-398b", **over)
    jp, tp = layer_params(jmb.mamba_init, jcfg, seed)
    return jcfg, tcfg, jp, tp


# chunk 16 at the reduced size: 3 chunks, 1 chunk, 2 chunks of 20, and
# shorter than a chunk
@pytest.mark.parametrize("b,L", [(2, 48), (2, 16), (1, 40), (3, 7)])
def test_mamba_apply_matches_reference(b, L):
    jcfg, tcfg, jp, tp = mamba_case(seed=L)
    x = inputs(jcfg, b, L, seed=L)

    def jloss(p, xx):
        y = jmb.mamba_apply(jcfg, p, xx)
        return jnp.sum(y.astype(jnp.float32) ** 2), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ty = tmb.mamba_apply(tcfg, tp, xt)
    torch.sum(ty.float() ** 2).backward()
    assert ty.dtype == torch.bfloat16
    close_scaled(ty, jy)
    errs = {k: rel_fro(tp.get_parameter(k).grad.numpy(), np.asarray(jgp[k]))
            for k in jp}
    errs["x"] = rel_fro(f32(xt.grad), f32(jgx))
    assert max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("L", [48, 7])
def test_mamba_apply_fp32(L):
    jcfg, tcfg, jp, tp = mamba_case(seed=3)
    x = inputs(jcfg, 2, L, seed=9, dtype=jnp.float32)
    jy = jmb.mamba_apply(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        ty = tmb.mamba_apply(tcfg, tp, torch.from_numpy(x))
    assert ty.dtype == torch.float32
    close_scaled(ty, jy, FP32_TOL)


def test_mamba_decode_step_by_step():
    """12 tokens from zero states: each step's output, conv window and SSM
    state against the reference's; and the port's own apply over the same
    tokens equal to its steps."""
    jcfg, tcfg, jp, tp = mamba_case(seed=5)
    b, L = 2, 12
    x = inputs(jcfg, b, L, seed=11)
    jst = jmb.mamba_decode_init(jcfg, b)
    tst = tmb.mamba_decode_init(tcfg, b, 1)
    conv, h = tst["conv"][0], tst["h"][0]
    outs = []
    for t in range(L):
        xj = jnp.asarray(x[:, t: t + 1], jnp.bfloat16)
        jo, jst = jmb.mamba_decode(jcfg, jp, xj, jst)
        with torch.no_grad():
            to = tmb.mamba_decode(tcfg, tp, torch.from_numpy(x[:, t: t + 1]).bfloat16(),
                                  conv, h)
        close_scaled(to, jo)
        close_scaled(conv, jst["conv"])
        close_scaled(h, jst["h"])
        assert conv.dtype == torch.bfloat16 and h.dtype == torch.float32
        outs.append(to)
    with torch.no_grad():
        whole = tmb.mamba_apply(tcfg, tp, torch.from_numpy(x).bfloat16())
    close_scaled(torch.cat(outs, 1), whole)


@pytest.mark.parametrize("L,chunk", [(33, 16), (50, 16), (257, 128)])
def test_mamba_lengths_the_chunking_rejects(L, chunk):
    """``L // chunk`` chunks of ``L // nc``: 33 = 2 x 16 + 1, 50 = 3 x 16 + 2,
    257 = 2 x 128 + 1 do not split; the reference's reshape fails and the
    port raises ValueError, without padding."""
    mc = dict(d_state=8, d_conv=4, expand=2, chunk=chunk)
    from repro.configs.base import MambaConfig as JMC
    from repro_torch.configs.base import MambaConfig

    jcfg, tcfg = configs("jamba-1.5-large-398b")
    import dataclasses

    jcfg = dataclasses.replace(jcfg, mamba=JMC(**mc))
    tcfg = dataclasses.replace(tcfg, mamba=MambaConfig(**mc))
    jp, tp = layer_params(jmb.mamba_init, jcfg, 0)
    x = inputs(jcfg, 1, L, seed=1)
    with pytest.raises(TypeError):
        jmb.mamba_apply(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(ValueError, match=f"length {L}"):
        tmb.mamba_apply(tcfg, tp, torch.from_numpy(x).bfloat16())


def test_doubling_scan_is_the_recurrence():
    """The within-chunk doubling scan equals the step-by-step recurrence
    h_t = a_t h_{t-1} + b_t (fp64, c not a power of two)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)))
    b = torch.from_numpy(rng.normal(size=(2, 37, 3, 4)))
    pa, pb = tmb._doubling_scan(a, b)
    h, ca = torch.zeros(2, 3, 4, dtype=torch.float64), torch.ones(2, 3, 4, dtype=torch.float64)
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        ca = ca * a[:, t]
        torch.testing.assert_close(pb[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(pa[:, t], ca, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- RWKV-6 ---

def rwkv_case(seed=0):
    jcfg, tcfg = configs("rwkv6-7b")
    jp, tp = layer_params(jrk.rwkv_init, jcfg, seed)
    jc, tc = layer_params(jrk.rwkv_channel_mix_init, jcfg, seed + 1)
    return jcfg, tcfg, jp, tp, jc, tc


@pytest.mark.parametrize("b,L", [(2, 48), (1, 130), (3, 5)])
def test_rwkv_apply_matches_reference(b, L):
    """Time mix and channel mix; one WKV chunk up to 128 tokens, and 130
    tokens (130 // 128 = 1 chunk of 130)."""
    jcfg, tcfg, jp, tp, jc, tc = rwkv_case(seed=L)
    x = inputs(jcfg, b, L, seed=L)

    def jloss(p, c, xx):
        y = jrk.rwkv_apply(jcfg, p, xx)
        z = jrk.rwkv_channel_mix(jcfg, c, xx)
        return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(
            z.astype(jnp.float32) ** 2), (y, z)

    (_, (jy, jz)), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jp, jc, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ty = trk.rwkv_apply(tcfg, tp, xt)
    tz = trk.rwkv_channel_mix(tcfg, tc, xt)
    (torch.sum(ty.float() ** 2) + torch.sum(tz.float() ** 2)).backward()
    close_scaled(ty, jy)
    close_scaled(tz, jz)
    errs = {f"tm.{k}": rel_fro(tp.get_parameter(k).grad.numpy(), np.asarray(grads[0][k]))
            for k in jp}
    errs.update({f"cm.{k}": rel_fro(tc.get_parameter(k).grad.numpy(),
                                    np.asarray(grads[1][k])) for k in jc})
    errs["x"] = rel_fro(f32(xt.grad), f32(grads[2]))
    assert max(errs.values()) <= GRAD_TOL, errs


def test_rwkv_apply_fp32():
    jcfg, tcfg, jp, tp, jc, tc = rwkv_case(seed=2)
    x = inputs(jcfg, 2, 40, seed=3, dtype=jnp.float32)
    jy = jrk.rwkv_apply(jcfg, jp, jnp.asarray(x))
    jz = jrk.rwkv_channel_mix(jcfg, jc, jnp.asarray(x))
    with torch.no_grad():
        ty = trk.rwkv_apply(tcfg, tp, torch.from_numpy(x))
        tz = trk.rwkv_channel_mix(tcfg, tc, torch.from_numpy(x))
    close_scaled(ty, jy, FP32_TOL)
    close_scaled(tz, jz, FP32_TOL)


def test_rwkv_decode_step_by_step():
    """12 tokens from zero states through the time mix and channel mix
    with state: each step's outputs, token shifts and WKV state against
    the reference's; the port's own apply over the same tokens equal to
    its steps."""
    jcfg, tcfg, jp, tp, jc, tc = rwkv_case(seed=4)
    b, L = 2, 12
    x = inputs(jcfg, b, L, seed=13)
    jst = jrk.rwkv_decode_init(jcfg, b)
    tst = trk.rwkv_decode_init(tcfg, b, 1)
    tm, cm = tst["tm"], tst["cm"]
    ys = []
    for t in range(L):
        xj = jnp.asarray(x[:, t: t + 1], jnp.bfloat16)
        jy, jtm = jrk.rwkv_apply(jcfg, jp, xj, state=jst["tm"], return_state=True)
        jz, jcm = jrk.rwkv_channel_mix(jcfg, jc, xj, state=jst["cm"],
                                       return_state=True)
        jst = {"tm": jtm, "cm": jcm}
        xt = torch.from_numpy(x[:, t: t + 1]).bfloat16()
        with torch.no_grad():
            ty = trk.rwkv_apply(tcfg, tp, xt, shift=tm["shift"][0], wkv=tm["wkv"][0])
            tz = trk.rwkv_channel_mix(tcfg, tc, xt, shift=cm["shift"][0])
        close_scaled(ty, jy)
        close_scaled(tz, jz)
        close_scaled(tm["wkv"][0], jtm["wkv"])
        np.testing.assert_array_equal(f32(tm["shift"][0]), f32(jtm["shift"]))
        np.testing.assert_array_equal(f32(cm["shift"][0]), f32(jcm["shift"]))
        ys.append(ty)
    with torch.no_grad():
        whole = trk.rwkv_apply(tcfg, tp, torch.from_numpy(x).bfloat16())
    close_scaled(torch.cat(ys, 1), whole)


@pytest.mark.parametrize("L", [257, 259])
def test_rwkv_lengths_the_chunking_rejects(L):
    """The WKV chunk is min(128, L): 257 tokens make 2 chunks of 128 and
    259 tokens 2 of 129, neither L; the reference's reshape fails and the
    port raises ValueError."""
    jcfg, tcfg, jp, tp, _, _ = rwkv_case(seed=1)
    x = inputs(jcfg, 1, L, seed=2)
    with pytest.raises(TypeError):
        jrk.rwkv_apply(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    with pytest.raises(ValueError, match=f"length {L}"):
        trk.rwkv_apply(tcfg, tp, torch.from_numpy(x).bfloat16())
