"""Port parity: AdamW, the train step and the trainer against `repro`.

``optimizer.apply`` on identical fp32 inputs: every parameter within
1e-6 of its leaf's largest magnitude (one fp32 rounding of the update:
XLA fuses and contracts the chain, PyTorch rounds each op; an element
the update cancels toward zero keeps only that absolute error), bf16
moments bit for bit (the fp32 moments before rounding differ by at most
an ulp, which the round to bf16 absorbs), fp32 moments within 1e-6 of
their leaf's largest magnitude, as the parameters.  Three
``build_train_step`` steps at ``microbatches=2`` from the same weights:
the losses within 2e-2, for every LM arch (the FP32_ARCHS with fp32
activations in both packages, torch_lm_common).  The trainer on the CPU:
a falling loss, and a resume; the encoder-decoder's frames drawn as the
reference's trainer draws them.
"""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jzoo
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.launch import train as tlaunch
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from torch_lm_common import (FP32_ARCHS, LM_ARCHS, batch_np, configs,
                             fp32_activations, jax_params, to_jax, to_torch,
                             torch_model)

SHAPES = {"w": (64, 128), "emb": (512, 64), "scale": (64,),
          "stacked": (2, 4, 16, 64)}


def leaves(seed):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    g = {k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    m = {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    v = {k: (1e-3 * rng.random(s)).astype(np.float32) for k, s in SHAPES.items()}
    return p, g, m, v


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("step", [0, 5, 150])
def test_adamw_apply(moment_dtype, step):
    p, g, m, v = leaves(step)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=200,
                            moment_dtype=moment_dtype)
    tcfg = topt.AdamWConfig(*jcfg)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    jstate = {"step": jnp.int32(step),
              "m": {k: jnp.asarray(a, jdt) for k, a in m.items()},
              "v": {k: jnp.asarray(a, jdt) for k, a in v.items()}}
    jp, jst, jmet = jax.jit(lambda *a: jopt.apply(jcfg, *a))(
        {k: jnp.asarray(a) for k, a in p.items()}, jstate,
        {k: jnp.asarray(a) for k, a in g.items()})
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    tstate = {"step": step,
              "m": {k: torch.from_numpy(a).to(tdt) for k, a in m.items()},
              "v": {k: torch.from_numpy(a).to(tdt) for k, a in v.items()}}
    _, tst, tmet = topt.apply(tcfg, tp, tstate, {k: torch.from_numpy(a) for k, a in g.items()})
    assert tst["step"] == int(jst["step"]) == step + 1
    assert float(tmet["lr"]) == float(jmet["lr"])
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-6)
    for k in p:
        want = np.asarray(jp[k])
        assert np.max(np.abs(tp[k].numpy() - want)) <= 1e-6 * np.max(np.abs(want)), k
        for name in ("m", "v"):
            got = tst[name][k].float().numpy()
            ref = np.asarray(jnp.asarray(jst[name][k], jnp.float32))
            if moment_dtype == "bfloat16":
                assert tst[name][k].dtype == torch.bfloat16
                np.testing.assert_array_equal(got, ref, err_msg=f"{name} {k}")
            else:
                assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref)), \
                    f"{name} {k}"


def test_schedule_and_init():
    cfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    for step in (0, 1, 7, 20, 21, 60, 99, 100, 150):
        assert float(topt.schedule(topt.AdamWConfig(*cfg), step)) == \
            float(jopt.schedule(cfg, jnp.int32(step))), step
    st = topt.init(topt.AdamWConfig(), {"a": torch.ones(3, 2)})
    assert st["step"] == 0 and st["m"]["a"].dtype == torch.bfloat16
    assert not st["v"]["a"].any()
    assert topt.init(topt.AdamWConfig(moment_dtype="float32"),
                     {"a": torch.ones(2)})["m"]["a"].dtype == torch.float32


def test_missing_gradient_counts_as_zero():
    """A parameter the loss never reaches (command-r's unused norm2) still
    decays, as the reference's zero gradient leaf does."""
    p = {"a": torch.ones(4), "b": torch.full((2,), 2.0)}
    st = topt.init(topt.AdamWConfig(lr=0.1, warmup_steps=0), p)
    _, _, met = topt.apply(topt.AdamWConfig(lr=0.1, warmup_steps=0), p, st,
                           {"a": torch.ones(4), "b": None})
    assert float(met["grad_norm"]) == 2.0
    assert torch.all(p["b"] < 2.0)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_three_train_steps_microbatched(arch):
    """Three steps of 4 sequences in 2 microbatches from the same weights."""
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    with (fp32_activations() if arch in FP32_ARCHS else contextlib.nullcontext()):
        _three_steps(jcfg, tcfg, jp, model)


def _three_steps(jcfg, tcfg, jp, model):
    adamw = jopt.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=50)
    jt = jloop.TrainConfig(microbatches=2, adamw=adamw)
    tt = tloop.TrainConfig(microbatches=2, adamw=topt.AdamWConfig(*adamw))
    jstep = jax.jit(jloop.build_train_step(jcfg, jt))
    tstep = tloop.build_train_step(tcfg, tt)
    jopt_state = jopt.init(adamw, jp)
    topt_state = topt.init(tt.adamw, dict(model.named_parameters()))
    for i in range(3):
        b = batch_np(jcfg, 4, 32, seed=10 + i)
        jp, jopt_state, jm = jstep(jp, jopt_state, to_jax(b))
        model, topt_state, tm = tstep(model, topt_state, to_torch(b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-2, i
        assert abs(float(tm["acc"]) - float(jm["acc"])) <= 2 / b["mask"].sum()
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=3e-2)
    assert all(p.grad is None for p in model.parameters())


def test_microbatches_average_the_full_batch_gradient():
    """Two microbatches of equal masks give the one-batch gradient and loss."""
    jcfg, tcfg = configs("yi-6b")
    b = batch_np(jcfg, 4, 32, seed=20)
    b["mask"][:] = 1.0
    out = []
    for n in (1, 2):
        model = torch_model(tcfg, jax_params(jcfg))
        tt = tloop.TrainConfig(microbatches=n, adamw=topt.AdamWConfig(lr=0.0))
        _, st, met = tloop.build_train_step(tcfg, tt)(
            model, topt.init(tt.adamw, dict(model.named_parameters())), to_torch(b))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-2)
    assert out[0][1] == pytest.approx(out[1][1], rel=3e-2)


def test_split_micro():
    b = {"tokens": torch.arange(24).reshape(4, 6), "mask": torch.ones(4, 6)}
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    got, want = tloop._split_micro(b, 2), jloop._split_micro(jb, 2)
    for k in b:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_init_state_cpu():
    jcfg, tcfg = configs("internvl2-1b")
    model, st = tloop.init_state(tcfg, tloop.TrainConfig(),
                                 torch.Generator().manual_seed(0), device="cpu")
    assert sorted(st["m"]) == sorted(n for n, _ in model.named_parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jax.eval_shape(
            lambda: jzoo.init(jcfg, jax.random.PRNGKey(0)))))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b", "yi-6b"])
def test_trainer_batches_are_the_references(arch, monkeypatch):
    """The trainer feeds the reference trainer's batches, key for key and
    value for value: tokens from the same pool, then the encoder-decoder's
    frames or the VLM's prefix embeddings, drawn from the same stream in
    the same order."""
    from repro.launch import train as jlaunch

    seen = {"jax": [], "torch": []}

    def jbuild(cfg, tcfg):
        def step(params, opt, batch):
            jax.debug.callback(
                lambda b: seen["jax"].append({k: np.asarray(v) for k, v in b.items()}),
                batch)
            zero = jnp.float32(0)
            return params, opt, {"loss": zero, "acc": zero, "grad_norm": zero}
        return step

    def tbuild(cfg, tcfg):
        def step(params, opt, batch):
            seen["torch"].append({k: v.numpy() for k, v in batch.items()})
            return params, opt, {"loss": 0.0, "acc": 0.0, "grad_norm": 0.0}
        return step

    monkeypatch.setattr(jlaunch.train_loop, "build_train_step", jbuild)
    monkeypatch.setattr(tlaunch.train_loop, "build_train_step", tbuild)
    args = ["--arch", arch, "--smoke", "--steps", "3", "--seq", "16",
            "--batch", "2"]
    jlaunch.main(args)
    tlaunch.main(args + ["--device", "cpu"])
    jax.effects_barrier()
    assert len(seen["jax"]) == len(seen["torch"]) == 3
    for want, got in zip(seen["jax"], seen["torch"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


LOSS = re.compile(r"step\s+(\d+) loss=([0-9.]+) acc=([0-9.]+) gnorm=([0-9.]+)")


def test_trainer_cpu_falling_loss_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "yi-6b", "--smoke", "--steps", "8", "--device", "cpu",
            "--ckpt-dir", ck, "--save-every", "4"]
    tlaunch.main(args)
    out = capsys.readouterr().out
    assert "arch=yi-6b-smoke params=0.1M steps=8" in out
    steps = [(int(s), float(l)) for s, l, _, _ in LOSS.findall(out)]
    assert [s for s, _ in steps] == [0, 7]
    assert steps[-1][1] < steps[0][1]
    assert "done: 8 steps" in out and "timing: device=cpu" in out
    tlaunch.main(args)
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "done: 0 steps" in out
    assert not LOSS.findall(out)

