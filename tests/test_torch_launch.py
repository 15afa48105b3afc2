"""Port parity: `repro_torch.launch.{roofline,dryrun,report}` against `repro`.

* ``param_count``, ``train_analytic`` and ``serve_analytic`` equal to the
  reference's for every arch × cell (the same float arithmetic, so
  exactly).
* ``terms`` equal to the reference's under the same constants: the
  reference's TPU v5e numbers are passed as literals here (the port
  keeps no TPU constant); its default is the ``h100_sxm`` spec.
* A dry-run cell of a reduced config on the production mesh shapes:
  every local shard byte count checked against a numpy count made from
  the reference's own specs and shapes; no error; ``compile_s`` and
  ``cost`` null; on 16x16 the sharded step's record, its collectives
  (no cross-pod bytes) and its measured peak.
* ``report.main()`` on that result.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs import cells as jcells
from repro.configs.base import reduced as jreduced
from repro.dist import sharding as jshd
from repro.launch import roofline as jrf
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCH_IDS, cells, get_config, get_shape
from repro_torch.configs.base import reduced
from repro_torch.launch import dryrun, report
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import production_shape
from repro_torch.obs.roofline import DeviceSpec

# the reference's tpu_v5e spec (src/repro/obs/device_specs/tpu_v5e.json)
TPU_V5E = DeviceSpec(name="tpu_v5e", peak_flops=197e12, peak_word_ops=0.96e12,
                     hbm_bw=819e9, link_bw=50e9, launch_overhead_s=2e-6)
CELLS = [(a, s) for a in ARCH_IDS for s in cells(a)]


def _analytic(an) -> tuple:
    return an.flops, an.hbm_bytes, an.coll_bytes, an.notes


def test_cells_equal_reference():
    for arch in ARCH_IDS:
        assert cells(arch) == jcells(arch)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_analytic_equal_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = get_shape(shape_name), jget_shape(shape_name)
    assert rf.param_count(cfg) == jrf.param_count(jcfg)
    chips = 256
    if shape.kind == "train":
        micro = dryrun.microbatches_for(cfg, shape)
        got = rf.train_analytic(cfg, shape, chips, microbatches=micro)
        want = jrf.train_analytic(jcfg, jshape, chips, microbatches=micro)
    else:
        prefill = shape.kind == "prefill"
        got = rf.serve_analytic(cfg, shape, chips, prefill=prefill)
        want = jrf.serve_analytic(jcfg, jshape, chips, prefill=prefill)
    assert _analytic(got) == _analytic(want)
    for chips in (256, 512):
        assert rf.terms(got.flops, got.hbm_bytes, got.coll_bytes, chips,
                        TPU_V5E) == jrf.terms(want.flops, want.hbm_bytes,
                                              want.coll_bytes, chips)


def test_terms_default_is_h100():
    t = rf.terms(989e12, 3.35e12, 450e9, 1)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    h100 = DeviceSpec.load("h100_sxm")
    assert rf.terms(1e15, 1e12, 1e9, 8) == rf.terms(1e15, 1e12, 1e9, 8, h100)
    assert rf.terms(1e15, 1e12, 1e9, 8)["bottleneck"] == "compute"


def _numpy_bytes(jcfg, shape_name, sizes) -> dict:
    """Local shard bytes per device from the reference's shapes and specs."""
    def shard(shape, itemsize, spec) -> int:
        parts = math.prod(sizes[a] for w in spec
                          for a in ((w,) if isinstance(w, str) else (w or ())))
        assert int(np.prod(shape)) * itemsize % parts == 0
        return int(np.prod(shape)) * itemsize // parts

    mesh = type("StandIn", (), {"shape": dict(sizes)})()
    params = jax.eval_shape(lambda k: jzoo.init(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    pspecs = jshd.param_specs(params, mesh)
    leaves = jax.tree.leaves(params)
    specs = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    shape = jget_shape(shape_name)
    out = {"param_bytes": sum(shard(a.shape, 4, s) for a, s in zip(leaves, specs)),
           "opt_bytes": 0, "state_bytes": 0}
    if shape.kind == "train":  # two bf16 moments of every parameter
        out["opt_bytes"] = 2 * sum(shard(a.shape, 2, s)
                                   for a, s in zip(leaves, specs))
    ins = jzoo.input_specs(jcfg, shape)
    bspecs = jshd.batch_specs(ins["batch"], mesh)
    out["batch_bytes"] = sum(shard(a.shape, a.dtype.itemsize, bspecs[k])
                             for k, a in ins["batch"].items())
    if "state" in ins:
        sspecs = jax.tree.leaves(jshd.state_specs(ins["state"], mesh),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        out["state_bytes"] = sum(shard(a.shape, a.dtype.itemsize, s) for a, s in
                                 zip(jax.tree.leaves(ins["state"]), sspecs))
    return out


@pytest.fixture()
def reduced_cells(monkeypatch, tmp_path):
    """The dry run on reduced configs (full configs stay the default)."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: reduced(get_config(a)))
    return tmp_path / "dryrun_results_torch.json"


@pytest.mark.parametrize("arch,shape_name", [("yi-6b", "train_4k"),
                                             ("mixtral-8x7b", "decode_32k"),
                                             ("seamless-m4t-medium", "decode_32k")])
def test_reduced_cell_bytes(arch, shape_name, reduced_cells):
    res = dryrun.main(["--arch", arch, "--shape", shape_name, "--multi-pod",
                       "single"], results=reduced_cells)
    # 2x16x16 without its sharded step (tests/test_torch_dryrun_sharded.py
    # runs one multi-pod cell's)
    res[f"{arch}|{shape_name}|2x16x16"] = dryrun.lower_cell(arch, shape_name, True)
    jcfg = jreduced(jget_config(arch))
    for multi_pod in (False, True):
        rec = res[f"{arch}|{shape_name}|{dryrun.mesh_name(multi_pod)}"]
        assert "error" not in rec, rec.get("error")
        sizes = production_shape(multi_pod=multi_pod)
        assert rec["chips"] == math.prod(sizes.values())
        assert rec["compile_s"] is None and rec["cost"] is None
        if multi_pod:
            assert "sharded" not in rec and rec["collectives"] is None
        else:  # the sharded step ran as rank 0 of the mesh's fake group
            assert rec["sharded"]["error"] is None, rec["sharded"].get("trace")
            assert rec["collectives"]["cross_pod_bytes"] == 0
            assert rec["memory"]["measured"]["peak_bytes_full_depth_est"] >= \
                rec["memory"]["per_device_total"]
        assert rec["lower_s"] > 0
        assert rec["lower_blocks"] == f"1 of {jcfg.n_blocks} blocks"
        mem = rec["memory"]
        want = _numpy_bytes(jcfg, shape_name, sizes)
        for k, v in want.items():
            assert mem[k] == v, (k, mem[k], v)
        assert mem["per_device_total"] == sum(want.values())
        assert mem["fits"] is True
        a = rec["analytic"]
        assert a["roofline_s"] == max(a["compute_s"], a["memory_s"],
                                      a["collective_s"])


def test_report_main(reduced_cells, capsys):
    dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k"], results=reduced_cells)
    capsys.readouterr()
    out = report.main(reduced_cells)
    assert "## DRYRUN" in out and "## ROOFLINE" in out and "## MULTI" in out
    assert out.count("| yi-6b×decode_32k |") == 4  # 2 dry-run rows, roofline, multi
    assert "| yes |" in out
    assert capsys.readouterr().out.strip() == out.strip()


def test_blocks_cut_is_recorded():
    cfg, shape = get_config("yi-6b"), get_shape("decode_32k")
    rec = dryrun.run_step(cfg, shape, blocks=1)
    assert rec["lower_blocks"] == f"1 of {cfg.n_blocks} blocks"
    assert "lower_blocks" not in dryrun.run_step(reduced(cfg), shape, blocks=None)


@pytest.mark.parametrize("arch,shape_name,cut", [
    ("rwkv6-7b", "prefill_32k", True), ("jamba-1.5-large-398b", "prefill_32k", True),
    ("rwkv6-7b", "decode_32k", False), ("yi-6b", "prefill_32k", False)])
def test_loop_seq_cut_is_recorded(arch, shape_name, cut):
    """A step whose slots loop over time runs at LOOP_SEQ tokens, and says so."""
    shape = get_shape(shape_name)
    rec = dryrun.run_step(get_config(arch), shape)
    if cut:
        assert rec["lower_seq"] == f"{dryrun.LOOP_SEQ} of {shape.seq_len} tokens"
    else:
        assert "lower_seq" not in rec
    assert report.lower_cut(rec).startswith(rec["lower_blocks"])
