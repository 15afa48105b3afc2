"""Port parity: the LM configs and layers against `repro`.

Every config dataclass field for field; the norms, RoPE, MLPs and the
attention cores on the same seeded fp32 inputs within 1e-5 (fp32 kernels
of two libraries: the order of sums differs, nothing else); the chunked
loss in bf16 within 1e-2 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import genasm as jgenasm
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import layers as jlayers
import repro_torch.configs as tconfigs
from repro_torch.configs import genasm as tgenasm
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tlayers

FP32_TOL = 1e-5


def close(got, want, tol=FP32_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equal_field_for_field(arch):
    want, got = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.padded_vocab, got.n_blocks, got.sub_quadratic) == (
        want.hd, want.padded_vocab, want.n_blocks, want.sub_quadratic)
    assert dataclasses.asdict(tconfigs.reduced(got)) == dataclasses.asdict(
        jconfigs.reduced(want))
    assert tconfigs.cells(arch) == jconfigs.cells(arch)


def test_genasm_service_config_and_shapes_equal():
    got, want = tgenasm.CONFIG, jgenasm.CONFIG
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tuple(got.genasm) == tuple(want.genasm)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.base.SHAPES.items()}
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


def _holder(**arrays):
    return tlayers.holder(**{k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in arrays.items()})


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_fp32(norm):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, (3, 7, 64)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, 64).astype(np.float32)
    bias = rng.normal(0.0, 0.2, 64).astype(np.float32)
    cfg = tconfigs.reduced(tconfigs.get_config("yi-6b"), norm=norm)
    want = jlayers.apply_norm(cfg, {"scale": scale, "bias": bias}, jnp.asarray(x))
    got = tlayers.apply_norm(cfg, _holder(scale=scale, bias=bias),
                             torch.from_numpy(x))
    close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_half_rotation_fp32(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 140), (2, 40)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                             theta)
    close(got, want)
    # half rotation: position 0 is the identity, and dim 0 turns toward
    # dim dh/2 (not dim 1, as interleaved pairs would)
    zero = tlayers.apply_rope(torch.from_numpy(x), torch.zeros(2, 40,
                                                               dtype=torch.int32), theta)
    close(zero, x)
    e0 = torch.zeros(1, 1, 1, 16)
    e0[..., 0] = 1.0
    turned = tlayers.apply_rope(e0, torch.ones(1, 1, dtype=torch.int32), theta)
    close(turned[0, 0, 0], np.eye(16)[0] * np.cos(1.0) + np.eye(16)[8] * np.sin(1.0))


@pytest.mark.parametrize("act", ["silu_glu", "sq_relu", "gelu"])
def test_mlp_fp32(act):
    rng = np.random.default_rng(2)
    cfg = tconfigs.reduced(tconfigs.get_config("yi-6b"), act=act)
    p = {k: rng.normal(0, 0.1, s).astype(np.float32)
         for k, s in (("wi", (64, 128)), ("wg", (64, 128)), ("wo", (128, 64)))}
    if act != "silu_glu":
        del p["wg"]
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    want = jlayers.mlp_apply(cfg, p, jnp.asarray(x))
    got = tlayers.mlp_apply(cfg, _holder(**p), torch.from_numpy(x))
    close(got, want)


def test_dense_init_bounds():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init((8, 4, 16, 32), in_axis=(0, 1, 2), generator=gen)
    bound = 1 / np.sqrt(8 * 4 * 16)
    assert w.dtype == torch.float32 and w.abs().max() <= bound
    assert w.abs().max() > 0.9 * bound
    assert tlayers.dense_init((3, 5), device="meta").device.type == "meta"


QKV = dict(b=2, hkv=2, g=2, dh=16)
ATTN_CASES = [
    dict(sq=40, causal=True),
    dict(sq=40, causal=False),
    dict(sq=384, causal=True, blk_q=128),          # three q blocks
    dict(sq=200, causal=True, blk_q=64),           # ragged: largest divisor 50
    dict(sq=96, causal=True, sliding_window=24),
    dict(sq=96, causal=True, softcap=5.0),
    dict(sq=16, sk=48, causal=True, q_offset=32),  # a block late in the sequence
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_blockwise_attention_fp32(case):
    case = dict(case)
    sq = case.pop("sq")
    sk = case.pop("sk", sq)
    rng = np.random.default_rng(3)
    b, hkv, g, dh = QKV.values()
    q = rng.normal(size=(b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **case)
    got = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **case)
    close(got, want)


@pytest.mark.parametrize("sq,want", [(2048, 512), (33_024, 384), (100, 100),
                                     (130, 130), (1000, 500), (48, 48)])
def test_blk_q_rule(sq, want):
    assert tattn.pick_blk_q(sq) == want


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_fp32(window):
    """One token against a cache with empty (-1) slots and, for a sliding
    window, a ring whose slots hold positions beyond the window."""
    from torch_lm_common import configs, jax_params, torch_model

    jcfg, tcfg = configs("internvl2-1b", sliding_window=window)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    ja = jax.tree.map(lambda a: a[0], jp["blocks"]["slot0"]["attn"])
    ta = model.blocks[0].slot0.attn
    rng = np.random.default_rng(4)
    b, s = 2, 10
    x = rng.normal(size=(b, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(b, s, 2, 16)).astype(np.float32)
    cache_pos = np.array([0, 1, 2, 3, 4, 5, 6, -1, -1, 9], np.int32)
    for pos in (0, 3, 7, 9):
        want = jattn.decode_attention(jcfg, ja, jnp.asarray(x), jnp.asarray(ck),
                                      jnp.asarray(cv), jnp.asarray(cache_pos),
                                      jnp.int32(pos))
        got = tattn.decode_attention(tcfg, ta, torch.from_numpy(x),
                                     torch.from_numpy(ck), torch.from_numpy(cv),
                                     torch.from_numpy(cache_pos), pos)
        for g_, w_ in zip(got, want):
            close(g_, w_)


@pytest.mark.parametrize("s", [64, 1024])
def test_chunked_logits_xent(s):
    """bf16 hidden states against fp32 embeddings (cast to bf16 at use):
    loss within 1e-2 absolute; one chunk at s = 64, two at s = 1024."""
    rng = np.random.default_rng(5)
    b, d, vocab = 2, 64, 512
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    emb = rng.normal(0, 0.1, (vocab, d)).astype(np.float32)
    tgt = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    jl, jacc = jlayers.chunked_logits_xent(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(emb), jnp.asarray(tgt),
        jnp.asarray(mask))
    tl, tacc = tlayers.chunked_logits_xent(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(emb),
        torch.from_numpy(tgt), torch.from_numpy(mask))
    assert abs(float(tl) - float(jl)) <= 1e-2
    assert abs(float(tacc) - float(jacc)) <= 2 / mask.sum()


def test_frontend_embeds():
    cfg = tconfigs.reduced(tconfigs.get_config("internvl2-1b"))
    assert tfront.frontend_embed_shape(cfg, 3) == jfront.frontend_embed_shape(cfg, 3)
    assert tfront.frontend_embed_shape(cfg, 3, 5) == (3, 5, 32)
    e = tfront.synth_frontend_embeds(cfg, 2, device="cpu")
    assert e.shape == (2, 16, 32) and e.dtype == torch.float32
    assert 0.01 < float(e.std()) < 0.03
    assert torch.equal(e, tfront.synth_frontend_embeds(cfg, 2, device="cpu"))
