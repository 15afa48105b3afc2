"""Port parity: the model zoo's LMs (`repro_torch.models`) against `repro`.

The reduced configurations of the ten LM archs (dense, MoE, hybrid
Mamba, RWKV-6, encoder-decoder) run the same weights (the reference's
init, perturbed, carried by `models.convert`) on the same seeded
batches.  Tolerances: prefill logits in bf16 within rtol/atol 2e-2 (the
reference's own bound, tests/test_serving.py); hidden states in bf16
within 2e-2 of the tensor's largest magnitude (the final norm divides a
row by one rms, so an upstream rounding difference is the same size at
every element of the row: up to 3 bf16 ulps at |h| ~ 4, which an
elementwise rtol fails at the small elements); the loss within 1e-2
absolute; the MoE aux loss within 1e-3 relative; every gradient leaf
within 3e-2 relative Frobenius error (bf16 activations in both backward
passes).

MoE archs: both packages' routing is recorded at every MoE layer
(`torch_lm_common.RoutingRecorder`).  A token the two route differently
(a flip, allowed only below the reference's top-k gap ``ROUTE_EPS``)
jumps, and so does every later token of its row: those tokens are
tainted (``routing_taint``) and the values above are compared on the
others.  With a tainted token the loss and gradients are the
cross-entropy's over the untainted tokens (the mask), without the aux
loss, which reads every token's routing; the aux loss is then held to
2e-2 relative.

jamba and RWKV-6 (``FP32_ARCHS``) run these tests with fp32 activations
in both packages: in bf16 their stacks amplify the two packages'
rounding past the tolerances (torch_lm_common.FP32_ARCHS has the
measurements).  ``test_bf16_as_shipped`` holds them in bf16 to the loss,
the largest prefill logit and the flip rule.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.models import encdec as jed
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.models import convert
from repro_torch.models import encdec as ted
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from torch_lm_common import (BF16_TOL, FP32_ARCHS, LM_ARCHS, RoutingRecorder,
                             batch_np, configs, f32, fp32_activations,
                             jax_params, np_tree, rel_fro, routing_taint,
                             to_jax, to_torch, torch_grads, torch_model)

LOSS_TOL, GRAD_TOL, AUX_TOL = 1e-2, 3e-2, 1e-3


def bf16_close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_TOL, atol=BF16_TOL)


def scale_close(got, want):
    want = f32(want)
    assert np.max(np.abs(f32(got) - want)) <= BF16_TOL * np.max(np.abs(want))


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch_case(request):
    """(reference cfg, port cfg, reference params, port model); the
    FP32_ARCHS with fp32 activations in both packages."""
    jcfg, tcfg = configs(request.param)
    jp = jax_params(jcfg)
    ctx = (fp32_activations() if request.param in FP32_ARCHS
           else contextlib.nullcontext())
    with ctx:
        yield jcfg, tcfg, jp, torch_model(tcfg, jp)


@pytest.fixture
def routing(arch_case, monkeypatch):
    """A RoutingRecorder for an MoE arch, else None."""
    if arch_case[0].moe is None:
        yield None
        return
    rec = RoutingRecorder(monkeypatch)
    yield rec
    rec.close()


def taint_of(jcfg, rec, b, s, calls):
    """The recorded routing's taint [B, S] over the first ``calls`` MoE
    groups (one forward); every flip below ROUTE_EPS."""
    if rec is None:
        return np.zeros((b, s), bool)
    assert len(rec.ref) >= calls and len(rec.port) >= calls
    taint, flips, bad = routing_taint(rec.ref[:calls], rec.port[:calls], b, s)
    print(f"{jcfg.name}: {len(flips)} routing flips (group, token, gap) "
          f"{flips}; {int(taint.sum())} of {b * s} tokens tainted")
    assert not bad, bad
    return taint


def moe_groups(cfg) -> int:
    return cfg.n_blocks * len(cfg.moe_slots) if cfg.moe else 0


def hidden(pkg, cfg, params, b):
    """The family's forward: (hidden, aux)."""
    if cfg.enc_layers:
        return pkg["ed"].forward(cfg, params, b["tokens"], b["frames"])
    return pkg["tr"].forward(cfg, params, b["tokens"],
                             prefix_embeds=b.get("prefix_embeds"))


JAX, TORCH = {"ed": jed, "tr": jtr}, {"ed": ted, "tr": ttr}


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


def test_forward_hidden_and_prefill(arch_case, routing):
    jcfg, tcfg, jp, model = arch_case
    b = batch_np(jcfg, 2, 48, seed=1)
    jb, tb = to_jax(b), to_torch(b)
    jh, jaux = hidden(JAX, jcfg, jp, jb)
    with torch.no_grad():
        th, taux = hidden(TORCH, tcfg, model, tb)
    assert th.dtype == ttr.COMPUTE_DTYPE and th.shape == jh.shape
    taint = taint_of(jcfg, routing, 2, 48, moe_groups(jcfg))
    prefix = th.shape[1] - 48  # the VLM's prefix rows come first
    clean = np.concatenate([np.zeros((2, prefix), bool), ~taint], axis=1)
    scale_close(f32(th)[clean], f32(jh)[clean])
    if jcfg.moe is None:
        assert float(taux) == float(jaux) == 0.0
    else:
        tol = AUX_TOL if not taint.any() else BF16_TOL
        assert abs(float(taux) - float(jaux)) <= tol * abs(float(jaux))
    if routing:
        routing.clear()
    rows = ~taint[:, -1]
    pre = tzoo.prefill_fn(tcfg, model, tb), jzoo.prefill_fn(jcfg, jp, jb)
    assert rows.any() or jcfg.moe  # the dense rows are never tainted
    bf16_close(f32(pre[0])[rows], f32(pre[1])[rows])


def _loss_and_grads(jcfg, tcfg, jp, model, b, objective):
    jb, tb = to_jax(b), to_torch(b)

    def jloss(p):
        loss, m = jzoo.loss_fn(jcfg, p, jb)
        return (loss if objective == "loss" else m["xent"]), (loss, m)

    (_, (jl, jm)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    model.zero_grad(set_to_none=True)
    tl, tm = tzoo.loss_fn(tcfg, model, tb)
    (tl if objective == "loss" else tm["xent"]).backward()
    return jl, jm, jg, tl, tm


def test_loss_and_gradients(arch_case, routing):
    jcfg, tcfg, jp, model = arch_case
    b = batch_np(jcfg, 2, 48, seed=2)
    jl, jm, jg, tl, tm = _loss_and_grads(jcfg, tcfg, jp, model, b, "loss")
    taint = taint_of(jcfg, routing, 2, 48, moe_groups(jcfg))
    if taint.any():  # the cross-entropy of the untainted tokens alone
        b["mask"] = b["mask"] * ~taint
        routing.clear()
        aux = float(tm["aux"]), float(jm["aux"])
        assert abs(aux[0] - aux[1]) <= BF16_TOL * abs(aux[1])
        jl, jm, jg, tl, tm = _loss_and_grads(jcfg, tcfg, jp, model, b, "xent")
        again = taint_of(jcfg, routing, 2, 48, moe_groups(jcfg))
        assert (again == taint).all()  # the same routing as the first pass
    elif jcfg.moe is not None:
        assert abs(float(tm["aux"]) - float(jm["aux"])) <= AUX_TOL * float(jm["aux"])
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL
    assert abs(float(tm["xent"]) - float(jm["xent"])) <= LOSS_TOL
    assert abs(float(tm["acc"]) - float(jm["acc"])) <= 2 / max(b["mask"].sum(), 1)
    want = convert.flatten(np_tree(jg))
    got = torch_grads(model)
    model.zero_grad(set_to_none=True)
    assert sorted(got) == sorted(want)
    errs = {k: rel_fro(got[k], want[k]) for k in want
            if np.any(want[k])}  # command-r's norm2 gets no gradient in either
    assert max(errs.values()) <= GRAD_TOL, errs
    for k in set(want) - set(errs):
        assert not np.any(got[k]), k


@pytest.mark.parametrize("arch", FP32_ARCHS)
def test_bf16_as_shipped(arch, monkeypatch):
    """The FP32_ARCHS in bf16: every routing flip below ROUTE_EPS, the loss
    over the untainted tokens within LOSS_TOL, the prefill logits of
    untainted rows within BF16_TOL of the largest logit.  Prefill and the
    loss run the same forward, so they route alike."""
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    b = batch_np(jcfg, 2, 48, seed=2)
    rec = RoutingRecorder(monkeypatch) if jcfg.moe else None
    try:
        pre = (tzoo.prefill_fn(tcfg, model, to_torch(b)),
               jzoo.prefill_fn(jcfg, jp, to_jax(b)))
        taint = taint_of(jcfg, rec, 2, 48, moe_groups(jcfg))
        b["mask"] = b["mask"] * ~taint
        with torch.no_grad():
            tl, _ = tzoo.loss_fn(tcfg, model, to_torch(b))
        jl, _ = jzoo.loss_fn(jcfg, jp, to_jax(b))
    finally:
        if rec:
            rec.close()
    assert abs(float(tl) - float(jl)) <= LOSS_TOL
    rows = ~taint[:, -1]
    got, want = f32(pre[0])[rows], f32(pre[1])[rows]
    print(f"{arch}: bf16 loss {float(tl)} / {float(jl)}, prefill rows "
          f"compared {int(rows.sum())}")
    if rows.any():
        scale_close(got, want)


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


@pytest.mark.parametrize("arch", LM_ARCHS)
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


@pytest.mark.parametrize("arch", ["yi-6b", "internvl2-1b", "seamless-m4t-medium"])
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


def test_unported_families_raise(tmp_path):
    """A mesh and sequence parallelism, which raised until
    `repro_torch.dist.sharding` was ported, now run: ``sp`` without a mesh
    is a no-op (as the reference's ``constrain_activations``), and on a
    1x1 ("data", "model") mesh of a one-rank gloo world the decoder's
    forward and the MoE dispatch on DTensor parameters give the plain
    results (tests/test_torch_dist.py holds a 2x2 world)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = reduced(get_config("yi-6b"))
    model = tzoo.init(cfg, device="cpu")
    tokens = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    with torch.no_grad():
        want, _ = ttr.forward(cfg, model, tokens)
        got, _ = ttr.forward(cfg, model, tokens, sp=True)
    assert torch.equal(got, want)
    mcfg = reduced(get_config("mixtral-8x7b"))
    moe = tzoo.init(mcfg, device="cpu").blocks[0].slot0.moe
    x = torch.randn(2, 4, mcfg.d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want_moe, want_aux = tmoe.moe_apply(mcfg, moe, x)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh((1, 1), device_type="cpu")
        shd.shard_put(model, mesh)
        shd.shard_put(moe, mesh)
        with torch.no_grad():
            got, _ = ttr.forward(cfg, model, shd.shard_put(
                {"t": tokens}, mesh, {"t": ("data",)})["t"], mesh=mesh, sp=True)
            with shd.sharded_ops(mesh):
                got_moe, got_aux = tmoe.moe_apply(
                    mcfg, moe, shd.wrap_replicated(x, mesh), mesh=mesh)
        torch.testing.assert_close(got.full_tensor(), want, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(got_moe.full_tensor(), want_moe)
        assert float(got_aux.full_tensor()) == pytest.approx(float(want_aux))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_config_trains_prefills_and_decodes(arch):
    """Each reduced config builds from a generator, runs loss_fn with a
    backward pass, prefill_fn and two decode_fn steps on the CPU, with
    finite results and a gradient on every parameter the loss reaches."""
    cfg = reduced(get_config(arch))
    model = tzoo.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert isinstance(model, ted.EncDecLM if cfg.enc_layers else ttr.DecoderLM)
    b = to_torch(batch_np(cfg, 2, 16, seed=5))
    loss, m = tzoo.loss_fn(cfg, model, b)
    loss.backward()
    assert torch.isfinite(loss)
    assert float(m["aux"]) > 0 if cfg.moe else float(m["aux"]) == 0.0
    grads = [p.grad for n, p in model.named_parameters()
             if not (cfg.parallel_block and "norm2" in n)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    logits = tzoo.prefill_fn(cfg, model, b)
    assert logits.shape == (2, cfg.padded_vocab) and torch.isfinite(logits).all()
    st = tzoo.decode_state_init(cfg, 2, 8, device="cpu")
    batch = {"tokens": b["tokens"][:, :1]}
    if cfg.enc_layers:
        batch["memory"] = ted.encode(cfg, model, b["frames"]).detach()
    for pos in range(2):
        out, st = tzoo.decode_fn(cfg, model, st, batch, pos)
        assert out.shape == (2, cfg.padded_vocab) and torch.isfinite(out).all()


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
