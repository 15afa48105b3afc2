"""Port parity: the dense decoder LM (`repro_torch.models`) against `repro`.

The reduced configurations of the five dense archs run the same weights
(the reference's init, perturbed, carried by `models.convert`) on the
same seeded batches.  Tolerances: prefill logits in bf16 within
rtol/atol 2e-2 (the reference's own bound, tests/test_serving.py);
hidden states in bf16 within 2e-2 of the tensor's largest magnitude (the
final norm divides a row by one rms, so an upstream rounding difference
is the same size at every element of the row: up to 3 bf16 ulps at
|h| ~ 4, which an elementwise rtol fails at the small elements); the
loss within 1e-2 absolute; every gradient leaf within 3e-2 relative
Frobenius error (bf16 activations in both backward passes).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.models import convert
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from torch_lm_common import (BF16_TOL, DENSE_ARCHS, batch_np, configs, f32,
                             jax_params, np_tree, rel_fro, to_jax, to_torch,
                             torch_grads, torch_model)

LOSS_TOL, GRAD_TOL = 1e-2, 3e-2


def bf16_close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_TOL, atol=BF16_TOL)


def scale_close(got, want):
    want = f32(want)
    assert np.max(np.abs(f32(got) - want)) <= BF16_TOL * np.max(np.abs(want))


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def arch_case(request):
    jcfg, tcfg = configs(request.param)
    jp = jax_params(jcfg)
    return jcfg, tcfg, jp, torch_model(tcfg, jp)


def test_convert_round_trip(arch_case):
    jcfg, tcfg, jp, model = arch_case
    want = convert.flatten(np_tree(jp))
    got = convert.params_to_jax_tree(model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(a.shape)) for a in want.values())


def test_forward_hidden_and_prefill(arch_case):
    jcfg, tcfg, jp, model = arch_case
    b = batch_np(jcfg, 2, 48, seed=1)
    jb, tb = to_jax(b), to_torch(b)
    prefix = "prefix_embeds" in b
    jh, jaux = jtr.forward(jcfg, jp, jb["tokens"],
                           prefix_embeds=jb["prefix_embeds"] if prefix else None)
    with torch.no_grad():
        th, taux = ttr.forward(tcfg, model, tb["tokens"],
                               prefix_embeds=tb["prefix_embeds"] if prefix else None)
    assert th.dtype == torch.bfloat16 and th.shape == jh.shape
    scale_close(th, jh)
    assert float(taux) == float(jaux) == 0.0
    bf16_close(tzoo.prefill_fn(tcfg, model, tb), jzoo.prefill_fn(jcfg, jp, jb))


def test_loss_and_gradients(arch_case):
    jcfg, tcfg, jp, model = arch_case
    b = batch_np(jcfg, 2, 48, seed=2)
    jb, tb = to_jax(b), to_torch(b)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    model.zero_grad(set_to_none=True)
    tl, tm = tzoo.loss_fn(tcfg, model, tb)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
    assert abs(float(tm["xent"]) - float(jm["xent"])) <= LOSS_TOL
    assert abs(float(tm["acc"]) - float(jm["acc"])) <= 2 / b["mask"].sum()
    want = convert.flatten(np_tree(jg))
    got = torch_grads(model)
    model.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want)
    errs = {k: rel_fro(got[k], want[k]) for k in want
            if np.any(want[k])}  # command-r's norm2 gets no gradient in either
    assert max(errs.values()) <= GRAD_TOL, errs
    for k in set(want) - set(errs):
        assert not np.any(got[k]), k


def test_long_sequence_blocks_and_chunks():
    """S = 1,024: two q blocks of 512 in attention and two loss chunks,
    under per-block remat; loss, gradients and prefill as above."""
    jcfg, tcfg = configs("yi-6b")
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    b = batch_np(jcfg, 1, 1024, seed=3)
    jb, tb = to_jax(b), to_torch(b)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jzoo.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    tl, _ = tzoo.loss_fn(tcfg, model, tb)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
    want, got = convert.flatten(np_tree(jg)), torch_grads(model)
    assert max(rel_fro(got[k], want[k]) for k in want) <= GRAD_TOL
    bf16_close(tzoo.prefill_fn(tcfg, model, tb), jzoo.prefill_fn(jcfg, jp, jb))


def test_remat_does_not_change_loss_or_grads():
    jcfg, tcfg = configs("command-r-35b")
    model = torch_model(tcfg, jax_params(jcfg))
    tb = to_torch(batch_np(jcfg, 2, 32, seed=4))
    out = []
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        loss, _ = tzoo.loss_fn(tcfg, model, tb, remat=remat)
        loss.backward()
        out.append((float(loss), {k: v.copy() for k, v in torch_grads(model).items()}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k], err_msg=k)


SHAPES = [("train", 32, 2), ("prefill", 32, 2), ("decode", 64, 2)]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("int8", [False, True])
def test_input_specs_match(arch, int8, monkeypatch):
    monkeypatch.setattr(jtr, "KV_INT8", int8)
    monkeypatch.setattr(ttr, "KV_INT8", int8)
    jcfg, tcfg = configs(arch)
    for kind, s, b in SHAPES:
        want = jzoo.input_specs(jcfg, JShape("x", s, b, kind))
        got = tzoo.input_specs(tcfg, ShapeConfig("x", s, b, kind))
        wflat = convert.flatten(want)
        gflat = convert.flatten(got)
        assert sorted(gflat) == sorted(wflat)
        for k, w in wflat.items():
            g = gflat[k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), k
            assert str(g.dtype).split(".")[1] == str(w.dtype), k


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_synth_batch_is_the_references(arch, kind):
    jcfg, tcfg = configs(arch)
    want = jzoo.synth_batch(jcfg, JShape("x", 16, 2, kind), seed=3)["batch"]
    got = tzoo.synth_batch(tcfg, ShapeConfig("x", 16, 2, kind), seed=3,
                           device="cpu")["batch"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_init_draws_from_the_generator():
    cfg = reduced(get_config("internvl2-1b"))
    a = tzoo.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = tzoo.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    c = tzoo.init(cfg, torch.Generator().manual_seed(6), device="cpu")
    names = [n for n, _ in a.named_parameters()]
    assert "frontend_proj.w" in names and "lm_head.w" not in names  # tied
    assert "blocks.1.slot0.attn.bq" in names
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), n
        if n.endswith(("wq", "wo", "tokens")):
            assert not torch.equal(p, r), n
    emb = a.embed.tokens
    assert emb.shape == (cfg.padded_vocab, cfg.d_model)
    assert 0.015 < float(emb.std()) < 0.025
    assert float(a.blocks[0].slot0.norm1.scale.min()) == 1.0
    assert not a.blocks[0].slot0.attn.bq.any()


def test_unported_families_raise():
    for arch in ("mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
                 "rwkv6-7b", "seamless-m4t-medium"):
        cfg = reduced(get_config(arch))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tzoo.init(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tzoo.decode_state_init(cfg, 1, 8, device="cpu")
    cfg = reduced(get_config("yi-6b"))
    model = tzoo.init(cfg, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sharding"):
        ttr.forward(cfg, model, tokens, mesh=object())
    with pytest.raises(NotImplementedError, match="sharding"):
        ttr.forward(cfg, model, tokens, sp=True)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device cuda is valid")
    cfg = reduced(get_config("yi-6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tzoo.decode_state_init(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax(cfg, {})
