"""Port parity: checkpoints and the restartable loop against `repro`.

A checkpoint written by `repro.ckpt` restores in `repro_torch` equal to
the converted tree, bit for bit, and the reverse: the on-disk layout
(``step_<N>/manifest.json`` + ``arrays.npz``, the reference's flat
``"::"`` keys, bf16 saved as fp32) is the same.  `RestartableLoop`
resume and the ``keep`` garbage collection behave as the reference's,
and `Heartbeat` flags the same beats on the same clock.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager
from repro.dist import fault as jfault
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.dist import fault as tfault
from repro_torch.models import convert
from torch_lm_common import LM_ARCHS, configs, jax_params, np_tree, torch_model


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    jcfg, tcfg = configs(arch)
    jp = jax_params(jcfg)
    JManager(tmp_path).save(3, jp, blocking=True)
    model = convert.params_from_jax(tcfg, np_tree(jax_params(jcfg, seed=1)),
                                    device="cpu")  # other weights, overwritten
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 3
    assert mgr.restore(3, model) is model
    got = convert.params_to_jax_tree(model)
    want = convert.flatten(np_tree(jp))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ["yi-6b", "command-r-35b", "internvl2-1b",
                                  "mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "rwkv6-7b",
                                  "seamless-m4t-medium"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    jcfg, tcfg = configs(arch)
    model = torch_model(tcfg, jax_params(jcfg, seed=2))
    CheckpointManager(tmp_path).save(5, model, blocking=True, extra={"k": 1})
    template = jax_params(jcfg, seed=3)
    restored = JManager(tmp_path).restore(5, template)
    want = convert.params_to_jax_tree(model)
    got = convert.flatten(np_tree(restored))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    meta = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert meta["step"] == 5 and meta["keys"] == sorted(want)
    assert meta["extra"] == {"k": 1} and meta["n_devices"] >= 1


def test_dict_trees_and_bf16_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    jtree = {"opt": {"m": jnp.asarray(a, jnp.bfloat16)}, "w": jnp.asarray(b)}
    ttree = {"opt": {"m": torch.from_numpy(a).to(torch.bfloat16)},
             "w": torch.from_numpy(b)}
    JManager(tmp_path / "j").save(1, jtree, blocking=True)
    CheckpointManager(tmp_path / "t").save(1, ttree, blocking=True)
    for d in ("j", "t"):
        with np.load(tmp_path / d / "step_1" / "arrays.npz") as z:
            assert sorted(z.files) == ["opt::m", "w"]
            assert z["opt::m"].dtype == np.float32  # bf16 saved as fp32
    got = CheckpointManager(tmp_path / "j").restore(1, ttree)
    assert got["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(got["opt"]["m"], ttree["opt"]["m"])
    assert torch.equal(got["w"], ttree["w"])
    back = JManager(tmp_path / "t").restore(1, jtree)
    np.testing.assert_array_equal(np.asarray(back["opt"]["m"], np.float32),
                                  np.asarray(jtree["opt"]["m"], np.float32))
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(tmp_path / "t").restore(1, {"opt": {"m": torch.zeros(2)},
                                                      "w": ttree["w"]})


def _loop_run(fault, manager_cls, ck, n_steps, crash_at=None, save_every=3,
              keep=2):
    """A counter state stepped by ``fault.RestartableLoop``; crashes at a step."""
    mgr = manager_cls(ck, keep=keep)
    seen = []

    def step_fn(state, step):
        if step == crash_at:
            raise RuntimeError("crash")
        seen.append(step)
        return {"x": state["x"] + 1, "steps": state["steps"] + step}

    zero = ({"x": torch.zeros(2), "steps": torch.zeros((), dtype=torch.int64)}
            if manager_cls is CheckpointManager else
            {"x": jnp.zeros(2), "steps": jnp.zeros((), jnp.int32)})
    loop = fault.RestartableLoop(mgr, save_every=save_every)
    try:
        state = loop.run(zero, step_fn, n_steps=n_steps)
    except RuntimeError:
        mgr.wait()
        return None, seen, mgr.steps()
    return ({k: np.asarray(v).tolist() for k, v in state.items()}, seen,
            mgr.steps())


def test_restartable_loop_resume_and_gc_match_reference(tmp_path):
    runs = {}
    for name, fault, mgr in (("jax", jfault, JManager),
                             ("torch", tfault, CheckpointManager)):
        ck = tmp_path / name
        runs[name] = [
            _loop_run(fault, mgr, ck, 10, crash_at=7),  # saves 3, 6; dies at 7
            _loop_run(fault, mgr, ck, 10),              # resumes from 6
            _loop_run(fault, mgr, ck, 10),              # past the target
            _loop_run(fault, mgr, ck, 14, save_every=2),  # 10 -> 14, keep 2
        ]
    assert runs["torch"] == runs["jax"]
    first, second, third, fourth = runs["torch"]
    assert first == (None, list(range(7)), [3, 6])
    assert second[1] == [6, 7, 8, 9] and second[2] == [9, 10]
    assert second[0] == {"x": [10.0, 10.0], "steps": sum(range(10))}
    assert third[1] == [] and fourth[2] == [12, 14]


def test_save_async_one_in_flight_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": tree["w"] + step})
    mgr.wait()
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert torch.equal(mgr.restore(4, tree)["w"], tree["w"] + 4)


def test_failed_async_write_is_raised(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_7").write_text("a file where the directory goes")
    mgr.save(7, {"w": torch.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # raised once


def test_heartbeat_flags_the_same_beats(monkeypatch):
    gaps = [1.0] * 6 + [5.0, 1.0, 0.9, 3.5, 1.1]
    flags = {}
    for name, fault in (("jax", jfault), ("torch", tfault)):
        clock = iter(np.cumsum([0.0] + gaps))
        monkeypatch.setattr(fault.time, "monotonic", lambda: float(next(clock)))
        hb = fault.Heartbeat(factor=3.0, warmup=5)
        flags[name] = ([hb.beat() for _ in range(len(gaps) + 1)],
                       hb.straggler_count)
    assert flags["torch"] == flags["jax"]
    assert flags["torch"][1] == 2
