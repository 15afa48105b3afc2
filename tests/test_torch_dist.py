"""Port parity: `repro_torch.dist.sharding`, the pod-axis int8 all-reduce
and the sharded train step, against `repro`.

* ``_fit`` on the cases of tests/test_dist_unit.py, equal to the
  reference's and to the literal specs.
* ``param_specs``, ``batch_specs`` and ``state_specs`` of all ten archs
  at full size (the port's ``meta`` tensors against ``jax.eval_shape``)
  on the 16x16 and 2x16x16 production mesh shapes, equal spec for spec;
  a block leaf's spec is the reference's without its leading (stacked)
  entry.  The reference's resolver reads only ``mesh.shape``, so a
  stand-in with that attribute serves as its mesh.
* ``_quantize`` / ``_dequantize`` bit for bit; the pod mean over a
  2-rank gloo group (tests/torch_dist_worker.py) bit for bit against the
  reference's ``vmap(..., axis_name="pod")``.
* A gloo world of 4 processes running one sharded train step of the
  reduced yi-6b of tests/test_distribution.py and of the reduced mixtral
  (the MoE's dispatch constraint) on a 2x2 ("data", "model") mesh, of
  yi-6b on a 1x4 mesh (its 2 KV heads do not divide "model", so the KV
  projections are replicated and attention runs on replicated q, k and
  v, as on the production 16-way axis) and of yi-6b with
  sequence-parallel constraints (``sp``) on 2x2, against the port's
  unsharded step on
  the same weights and batch: loss within 1e-2, grad norm within 3e-2
  relative, each gradient and each updated parameter within 3e-2
  relative Frobenius.  Mixtral runs with fp32 activations in both steps
  (in bf16 the sharded reductions' order flips tokens' expert choices;
  tests/torch_lm_common.py).  The unsharded step is held against the
  reference's unsharded step (loss 2e-2, grad norm 3e-2 relative, as
  tests/test_torch_lm_train.py).
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.dist import sharding as jshd
from repro.models import model_zoo as jzoo
from repro.train import grad_compress as jgc
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import (dp_axes, mesh_shape, production_shape,
                                     tp_axis)
from repro_torch.models import convert, model_zoo
from repro_torch.train import grad_compress as gc
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from torch_lm_common import (batch_np, configs, fp32_activations, jax_params,
                             to_jax, to_torch, torch_model)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
ADAMW = dict(lr=5e-3, warmup_steps=2, total_steps=50)
LOSS_TOL, REL_TOL = 1e-2, 3e-2


class StandIn:
    """The reference's mesh as its resolver reads it: ``.shape`` only."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


# ------------------------------------------------------------------ _fit ---
FIT_CASES = [
    # (mesh sizes, shape, want, spec) — tests/test_dist_unit.py
    ({"data": 2, "model": 2}, (8, 16), (None, "model"), (None, "model")),
    ({"data": 2, "model": 2}, (3, 8, 16), (None, "model"), (None, None, "model")),
    ({"data": 2, "model": 2}, (16,), (None, "model"), ("model",)),
    ({"data": 2, "model": 2}, (7, 16), ("model", None), ()),
    ({"data": 2, "model": 2}, (8, 16), ("pod", "model"), (None, "model")),
    ({"data": 2, "model": 2}, (4, 8), ("model", "model"), ("model",)),
    ({"data": 1}, (8, 16), ("model", "data"), (None, "data")),
    ({"data": 1}, (7, 13), ("data", "model"), ("data",)),
    ({"data": 4, "model": 1}, (6, 9), (None, "model"), (None, "model")),
    ({"pod": 2, "data": 2}, (4, 8), (("pod", "data"), None), (("pod", "data"),)),
    ({"pod": 2, "data": 2}, (2, 8), (("pod", "data"), None), ("pod",)),
]


@pytest.mark.parametrize("sizes,shape,want,spec", FIT_CASES)
def test_fit_matches_reference(sizes, shape, want, spec):
    got = shd._fit(sizes, shape, want)
    assert got == spec
    assert got == tuple(jshd._fit(StandIn(sizes), shape, want))


def test_mesh_helpers():
    single, multi = production_shape(), production_shape(multi_pod=True)
    assert single == {"data": 16, "model": 16}
    assert multi == mesh_shape((2, 16, 16), ("pod", "data", "model"))
    assert dp_axes(single) == ("data",) and dp_axes(multi) == ("pod", "data")
    assert tp_axis(multi) == "model"
    with pytest.raises(ValueError):
        mesh_shape((2, 2), ("data",))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert shd.placements((("pod", "data"), None, "model"), Mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, "model"), Mesh) == (
        Replicate(), Replicate(), Shard(1))
    assert shd.placements((), Mesh) == (Replicate(),) * 3


def test_stacked_specs_and_shard_mesh():
    tree = {"bases": torch.empty(4, 100, device="meta"),
            "pos": torch.empty(3, 7, device="meta")}
    jtree = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
             for k, v in tree.items()}
    for sizes in ({"shard": 2}, {"shard": 4}, {"data": 2}):
        want = jshd.stacked_specs(jtree, StandIn(sizes))
        assert shd.stacked_specs(tree, sizes) == {k: tuple(v)
                                                  for k, v in want.items()}
    devices = (torch.device("cpu"),) * 2  # a shard_mesh device tuple
    assert shd.stacked_specs(tree, devices) == {"bases": ("shard",), "pos": ()}
    assert shd.shard_mesh(1) is None
    if not torch.cuda.is_available():
        assert shd.shard_mesh(2) is None


# --------------------------------------------------- spec trees, full size ---
def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _jflat(tree) -> dict:
    return {"::".join(str(p.key) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _unstack(spec: tuple) -> tuple:
    out = list(spec[1:])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jget_config(arch)
            cache[arch] = jax.eval_shape(lambda k: jzoo.init(cfg, k),
                                         jax.ShapeDtypeStruct((2,), jnp.uint32))
        return cache[arch]
    return get


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, multi_pod, ref_params):
    sizes = production_shape(multi_pod=multi_pod)
    want = _jflat(jshd.param_specs(ref_params(arch), StandIn(sizes)))
    model = model_zoo.init(get_config(arch), device="meta")
    got = shd.param_specs(model, sizes)
    seen = set()
    for name, spec in got.items():
        key, blk = convert.jax_key(name)
        ref = want[key] if blk is None else _unstack(want[key])
        assert spec == ref, (name, spec, want[key])
        seen.add(key)
    assert seen == set(want)
    # the reference's rules hold: experts and heads over "model"
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_state_specs_equal_reference(arch, multi_pod):
    sizes = production_shape(multi_pod=multi_pod)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for shape_name in ("train_4k", "decode_32k"):
        jspecs = jzoo.input_specs(jcfg, jget_shape(shape_name))
        specs = model_zoo.input_specs(cfg, get_shape(shape_name))
        want = _jflat(jshd.batch_specs(jspecs["batch"], StandIn(sizes)))
        assert shd.batch_specs(specs["batch"], sizes) == want
        if "state" in specs:
            want = _jflat(jshd.state_specs(jspecs["state"], StandIn(sizes)))
            got = {"::".join(p): s for p, s in
                   _flat(shd.state_specs(specs["state"], sizes))}
            assert got == want


# ------------------------------------------------------ int8 compression ---
@pytest.mark.parametrize("n,scale", [(4096, 0.02), (5000, 1.0), (2048, 0.0),
                                     (17, 3e-3)])
def test_quantize_bit_for_bit(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(0, 1, size=n) * scale).astype(np.float32)
    if n > 100:
        x[100:140] = 0.0  # a zero run: the 1e-12 scale floor
        x[7] = 0.5 * np.float32(x[:2048].max() or 1.0)  # ties to even
    q, s, nn = gc._quantize(torch.from_numpy(x))
    jq, js, jn = jgc._quantize(jnp.asarray(x))
    assert nn == jn == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(gc._dequantize(q, s, n).numpy(),
                                  np.asarray(jgc._dequantize(jq, js, jn)))


def test_round_half_to_even():
    xb = np.zeros(2048, np.float32)
    xb[0] = 127.0  # scale exactly 1
    xb[1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    q, s, _ = gc._quantize(torch.from_numpy(xb))
    assert float(s[0, 0]) == 1.0
    assert q[0, 1:6].tolist() == [0, 2, 2, 0, -2]
    assert q[0, 1:6].tolist() == np.asarray(jgc._quantize(jnp.asarray(xb))[0])[0, 1:6].tolist()


def _run_worker(case: str, out: Path, timeout: int) -> None:
    proc = subprocess.run([sys.executable, str(WORKER), case, str(out)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]


def test_pod_mean_bit_for_bit(tmp_path):
    """Two pods, gloo: each rank's mean and residual against the
    reference's ``compressed_psum_mean`` vmapped over ``axis_name="pod"``."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.02, size=(2, 3 * 2048 + 77)).astype(np.float32)
    r = rng.normal(0, 1e-4, size=x.shape).astype(np.float32)
    np.savez(tmp_path / "pod_in.npz", x=x, r=r)
    _run_worker("pod", tmp_path, timeout=180)
    jmean, jresid = jax.vmap(lambda g, rr: jgc.compressed_psum_mean(g, rr, "pod"),
                             axis_name="pod")(jnp.asarray(x), jnp.asarray(r))
    for rank in (0, 1):
        got = np.load(tmp_path / f"pod_out_{rank}.npz")
        np.testing.assert_array_equal(got["mean"], np.asarray(jmean[rank]))
        np.testing.assert_array_equal(got["resid"], np.asarray(jresid[rank]))
        np.testing.assert_array_equal(got["tree_mean"], got["mean"])
        np.testing.assert_array_equal(got["tree_resid"], got["resid"])


def test_pod_allreduce_needs_a_pod_axis():
    class Mesh:
        mesh_dim_names = ("data", "model")

    assert gc.make_pod_compressed_allreduce(Mesh, {}) is None
    assert jgc.make_pod_compressed_allreduce(
        jax.make_mesh((1, 1), ("data", "model")), {}) is None


# ------------------------------------------------------ sharded train step ---
# case -> (arch, fp32 activations, mesh (data, model), sp); the fp32
# cases come last (the worker keeps fp32 from the first one on)
TRAIN_CASES = {"yi-6b": ("yi-6b", False, (2, 2), False),
               "yi-6b-model4": ("yi-6b", False, (1, 4), False),
               "yi-6b-sp": ("yi-6b", False, (2, 2), True),
               "mixtral-8x7b": ("mixtral-8x7b", True, (2, 2), False)}
TRAIN_ARCHS = {"yi-6b": False, "mixtral-8x7b": True}  # arch -> fp32 activations


def _act(fp32: bool):
    return fp32_activations() if fp32 else contextlib.nullcontext()


def _batch(jcfg, arch):
    return batch_np(jcfg, 4, 32, seed=30 + len(arch))


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """One gloo world of 4 ranks runs the sharded step of every case."""
    out = tmp_path_factory.mktemp("dist_train")
    lines = []
    for name, (arch, fp32, (data, model_ax), sp) in TRAIN_CASES.items():
        jcfg, tcfg = configs(arch)
        model = torch_model(tcfg, jax_params(jcfg))
        torch.save(model.state_dict(), out / f"{name}.pt")
        np.savez(out / f"{name}_batch.npz", **_batch(jcfg, arch))
        lines.append(f"{name} {arch} {int(fp32)} {data} {model_ax} {int(sp)}")
    (out / "train_cases.txt").write_text("\n".join(lines))
    _run_worker("train", out, timeout=900)
    return out


def _unsharded_step(tcfg, model, batch):
    """The port's unsharded step: (metrics, gradients, updated params)."""
    tt = tloop.TrainConfig(microbatches=2, adamw=topt.AdamWConfig(**ADAMW))
    grads, real = {}, tloop.opt_mod.apply

    def capture(acfg, params, state, g):
        grads.update({k: v.clone() for k, v in g.items() if v is not None})
        return real(acfg, params, state, g)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloop.opt_mod, "apply", capture)
        _, _, met = tloop.build_train_step(tcfg, tt)(
            model, topt.init(tt.adamw, dict(model.named_parameters())),
            to_torch(batch))
    return met, grads, {k: p.detach().clone() for k, p in model.named_parameters()}


def _rel(a, b) -> float:
    return float(torch.linalg.norm((a - b).flatten()) /
                 max(float(torch.linalg.norm(b.flatten())), 1e-30))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_step_matches_unsharded(case, sharded_runs):
    arch, fp32, _, _ = TRAIN_CASES[case]
    jcfg, tcfg = configs(arch)
    with _act(fp32):
        met, grads, params = _unsharded_step(
            tcfg, torch_model(tcfg, jax_params(jcfg)), _batch(jcfg, arch))
    got = torch.load(sharded_runs / f"{case}_sharded.pt")
    assert abs(got["loss"] - float(met["loss"])) <= LOSS_TOL
    assert got["grad_norm"] == pytest.approx(float(met["grad_norm"]), rel=REL_TOL)
    assert set(got["grads"]) == set(grads)
    for k, g in grads.items():
        assert _rel(got["grads"][k], g) <= REL_TOL, k
    for k, p in params.items():
        assert _rel(got["params"][k], p) <= REL_TOL, k
    # the step ran sharded: heads, MLP and vocab over "model", every
    # parameter replicated over "data"
    shard_model = [k for k, pl in got["placements"].items() if pl[1].startswith("Shard")]
    assert any(".attn.wq" in k for k in shard_model)
    assert "embed.tokens" in shard_model
    assert all(pl[0].startswith("Replicate") for pl in got["placements"].values())
    if arch == "mixtral-8x7b":
        assert any(".moe.wi" in k for k in shard_model)
    if case == "yi-6b-model4":  # 2 KV heads on 4 "model" ranks: replicated
        assert not any(".attn.wk" in k or ".attn.wv" in k for k in shard_model)


@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_unsharded_step_matches_reference(arch):
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    b = _batch(jcfg, arch)
    with _act(TRAIN_ARCHS[arch]):
        met, _, _ = _unsharded_step(tcfg, torch_model(tcfg, jp), b)
        jt = jloop.TrainConfig(microbatches=2,
                               adamw=jopt.AdamWConfig(**ADAMW))
        _, _, jm = jax.jit(jloop.build_train_step(jcfg, jt))(
            jp, jopt.init(jt.adamw, jp), to_jax(b))
    assert abs(float(met["loss"]) - float(jm["loss"])) <= 2e-2
    assert float(met["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                    rel=REL_TOL)
