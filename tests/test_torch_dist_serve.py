"""Port parity: the sharded prefill, decode and train step of every model
family, on gloo worlds of 4 CPU processes, against the port's unsharded
path and the reference.

* One reduced config per family — dense (yi-6b), vision stub
  (internvl2-1b), MoE (mixtral-8x7b), Mamba hybrid (jamba), RWKV-6
  (rwkv6-7b), encoder-decoder (seamless-m4t-medium) — on a 2x2 ("data",
  "model") mesh, yi-6b there with the int8 KV cache (internvl2-1b's
  decoder is the dense bf16 case), and yi-6b on 1x4
  (its 2 KV heads do not divide 4: its cache and attention are
  replicated over "model", as on the production 16-way axis): parameters placed by ``shard_put``, the batch by
  ``batch_specs``, the decode state by ``shard_state``; a prefill of
  [4, 32] tokens and 8 decode steps teacher-forced from an empty cache
  (tests/torch_dist_worker.py, case ``serve``).
* The sharded logits against the port's unsharded path at BF16_TOL, and
  the unsharded path against the reference's ``prefill_fn`` and decode
  step at BF16_TOL (tests/torch_lm_common.py); the MoE archs, jamba and
  RWKV-6 run with fp32 activations everywhere (in bf16 the sharded
  reductions' order flips near-tied routing, as tests/test_torch_dist.py
  finds; jamba and RWKV-6 are FP32_ARCHS), and a token whose routing
  flips between the two packages is compared no more, by the flip rule.
* The state after 8 steps: every leaf still a DTensor with the
  placements of ``state_specs``, and equal to the unsharded state at
  BF16_TOL (the int8 cache's values are left to the logits).
* The sharded train step of jamba, rwkv6-7b and seamless, the families
  that tests/test_torch_dist.py's TRAIN_CASES lack, against the unsharded
  step at that file's tolerances (loss 1e-2; grad norm, gradients and
  updated parameters 3e-2 relative), with fp32 activations (TRAIN).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jed
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from test_torch_dist import (LOSS_TOL, REL_TOL, _rel, _run_worker,
                             _unsharded_step)
from test_torch_lm_serve import teacher_forced
from torch_lm_common import (BF16_TOL, RoutingRecorder, batch_np, configs,
                             decode_taint, f32, fp32_activations, jax_params,
                             routing_taint, torch_model)

B, PREFILL, STEPS = 4, 32, 8
FP32 = ("mixtral-8x7b", "jamba-1.5-large-398b", "rwkv6-7b")
# case -> (arch, mesh (data, model), int8 KV cache)
SERVE_CASES = {
    "yi-6b-int8": ("yi-6b", (2, 2), True),
    "internvl2-1b": ("internvl2-1b", (2, 2), False),
    "mixtral-8x7b": ("mixtral-8x7b", (2, 2), False),
    "jamba": ("jamba-1.5-large-398b", (2, 2), False),
    "rwkv6-7b": ("rwkv6-7b", (2, 2), False),
    "seamless": ("seamless-m4t-medium", (2, 2), False),
    "yi-6b-model4": ("yi-6b", (1, 4), False),
}
# the train step of the families TRAIN_CASES lacks, all with fp32
# activations: in bf16 seamless's smallest gradient leaf (norm_x.bias,
# ~1e-5) differs by 3.3% between the sharded and unsharded steps, in fp32
# by 6e-6
TRAIN = {"seamless-train": "seamless-m4t-medium",
         "jamba-train": "jamba-1.5-large-398b", "rwkv6-7b-train": "rwkv6-7b"}


def close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_TOL, atol=BF16_TOL)


def _act(arch: str, train: bool = False):
    return fp32_activations() if train or arch in FP32 else \
        contextlib.nullcontext()


def _inputs(jcfg, arch: str) -> dict:
    """The prefill batch and the decode tokens (and, for the encoder-
    decoder, the reference encoder's memory of the prefill frames)."""
    batch = batch_np(jcfg, B, PREFILL, seed=50 + len(arch))
    out = {k: v for k, v in batch.items() if k not in ("targets", "mask")}
    out["decode"] = batch["tokens"][:, :STEPS]
    if jcfg.enc_layers:
        with _act(arch):
            out["memory"] = f32(jed.encode(jcfg, jax_params(jcfg),
                                           jnp.asarray(batch["frames"])))
    return out


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """One gloo world of 4 ranks: every serve case, then the train cases."""
    out = tmp_path_factory.mktemp("dist_serve")
    lines = []
    for name, (arch, (data, model_ax), int8) in SERVE_CASES.items():
        jcfg, tcfg = configs(arch)
        torch.save(torch_model(tcfg, jax_params(jcfg)).state_dict(),
                   out / f"{name}.pt")
        np.savez(out / f"{name}_serve.npz", **_inputs(jcfg, arch))
        lines.append(f"{name} {arch} {int(arch in FP32)} {data} {model_ax} "
                     f"{int(int8)}")
    (out / "serve_cases.txt").write_text("\n".join(lines))
    lines = []
    for name, arch in TRAIN.items():
        jcfg, tcfg = configs(arch)
        torch.save(torch_model(tcfg, jax_params(jcfg)).state_dict(),
                   out / f"{name}.pt")
        np.savez(out / f"{name}_batch.npz", **_train_batch(jcfg, arch))
        lines.append(f"{name} {arch} 1 2 2 0")
    (out / "train_cases.txt").write_text("\n".join(lines))
    _run_worker("serve", out, timeout=600)
    return out


def _train_batch(jcfg, arch):
    return batch_np(jcfg, 4, 32, seed=60 + len(arch))


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serving_matches_unsharded_and_reference(case, dist_runs,
                                                         monkeypatch):
    arch, _, int8 = SERVE_CASES[case]
    monkeypatch.setattr(jtr, "KV_INT8", int8)
    monkeypatch.setattr(ttr, "KV_INT8", int8)
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    model = torch_model(tcfg, jp)
    inp = _inputs(jcfg, arch)
    toks, memory = inp.pop("decode"), inp.pop("memory", None)
    got = torch.load(dist_runs / f"{case}_served.pt")
    with contextlib.ExitStack() as stack:
        stack.enter_context(_act(arch))
        rec = RoutingRecorder(monkeypatch) if jcfg.moe else None
        if rec:
            stack.callback(rec.close)
        want = f32(jzoo.prefill_fn(jcfg, jp, {k: jnp.asarray(v)
                                              for k, v in inp.items()}))
        plain = f32(tzoo.prefill_fn(tcfg, model, {k: torch.from_numpy(v)
                                                  for k, v in inp.items()}))
        ptaint = np.zeros((B, PREFILL), bool)
        if rec:
            ptaint, _, bad = routing_taint(rec.ref, rec.port, B, PREFILL)
            assert not bad, bad
            rec.clear()
        ptaint = ptaint[:, -1]  # prefill's logits are the last position's
        steps, state = teacher_forced(jcfg, tcfg, jp, model, toks,
                                      max_len=STEPS + 8, memory=memory)
        dtaint = np.zeros((B, STEPS), bool)
        if rec:
            dtaint, _, bad = decode_taint(rec.ref, rec.port, B, STEPS)
            assert not bad, bad
    # the sharded run against the port's unsharded path
    close(got["prefill"], plain)
    for i, (_, tl) in enumerate(steps):
        close(got["decode"][:, i], tl)
    # the unsharded path against the reference, by the flip rule
    close(plain[~ptaint], want[~ptaint])
    for i, (jl, tl) in enumerate(steps):
        close(tl[~dtaint[:, i]], jl[~dtaint[:, i]])
    # the state kept its placements through the in-place updates
    for path, (ok, pl) in _flat(got["placements"]):
        assert ok, (path, pl)
    for path, leaf in _flat(state):
        whole = _at(got["state"], path)
        assert whole.shape == leaf.shape and whole.dtype == leaf.dtype, path
        if leaf.dtype == torch.int8 or path[-1] in ("k_scale", "v_scale"):
            continue
        if leaf.dtype == torch.int32:  # the cache's positions
            assert torch.equal(whole, leaf), path
        else:
            close(whole, leaf)
    if SERVE_CASES[case][1] == (2, 2) and "attn" in jcfg.pattern and \
            not jcfg.enc_layers:
        # a KV cache split over both mesh axes (2 KV heads on 2 ranks)
        kv = next(v for p, v in _flat(got["placements"]) if p[-1] == "k")
        assert kv[1] == ["Shard(dim=1)", "Shard(dim=3)"], kv


@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_train_step_of_the_other_families(case, dist_runs):
    arch = TRAIN[case]
    jcfg, tcfg = configs(arch)
    with _act(arch, train=True):
        met, grads, params = _unsharded_step(
            tcfg, torch_model(tcfg, jax_params(jcfg)), _train_batch(jcfg, arch))
    got = torch.load(dist_runs / f"{case}_sharded.pt")
    assert abs(got["loss"] - float(met["loss"])) <= LOSS_TOL
    assert got["grad_norm"] == pytest.approx(float(met["grad_norm"]), rel=REL_TOL)
    assert set(got["grads"]) == set(grads)
    for k, g in grads.items():
        assert _rel(got["grads"][k], g) <= REL_TOL, k
    for k, p in params.items():
        assert _rel(got["params"][k], p) <= REL_TOL, k
    shard_model = [k for k, pl in got["placements"].items()
                   if pl[1].startswith("Shard")]
    mixer = {"jamba-1.5-large-398b": ".mamba.in_proj", "rwkv6-7b": ".rwkv.wr",
             "seamless-m4t-medium": ".xattn.wq"}[arch]
    assert any(mixer in k for k in shard_model), shard_model
