"""Golden end-to-end regression for the port: its service emits the
reference's PAF byte for byte.

Runs `repro_torch.launch.serve_genomics` (simulate → index → engine →
PAF) with the `BASE_ARGS` of tests/test_e2e_paf_golden.py on the CPU
(``--device cpu``) and asserts the written PAF equals the committed
``tests/data/serve_golden.paf`` — offline and ``--online``, on the
``torch`` backend and on the ``cuda_dc*`` backends, whose batched window
loop runs the kernels' plain versions on the CPU.
"""
import pathlib

import pytest

from repro_torch.launch import serve_genomics

GOLDEN = pathlib.Path(__file__).parent / "data" / "serve_golden.paf"
BASE_ARGS = [
    "--ref-len", "3000", "--reads", "10", "--read-len", "100",
    "--batch", "4", "--buckets", "128", "--device", "cpu",
]


def _run_paf(tmp_path, backend: str, *, online: bool = False) -> bytes:
    out = tmp_path / f"{backend}{'_online' if online else ''}.paf"
    argv = BASE_ARGS + ["--align-backend", backend, "--out", str(out)]
    if online:
        argv += ["--online", "--rate", "2000"]
    summary = serve_genomics.main(argv)
    assert summary["align_backend"] == backend
    assert summary["mapped"] == 10
    return out.read_bytes()


@pytest.mark.parametrize("backend", ["torch", "cuda_dc", "cuda_dc_v2"])
def test_offline_paf_matches_golden(tmp_path, backend):
    assert _run_paf(tmp_path, backend) == GOLDEN.read_bytes(), \
        f"offline PAF for backend {backend} diverged from the snapshot"


@pytest.mark.parametrize("backend", ["torch", "cuda_dc"])
def test_online_paf_matches_golden(tmp_path, backend):
    """The online Poisson path emits the same PAF as the offline drain."""
    assert _run_paf(tmp_path, backend, online=True) == GOLDEN.read_bytes(), \
        f"online PAF for backend {backend} diverged from the snapshot"


def _run_sharded(tmp_path, backend: str, shards: int, *extra: str) -> bytes:
    tag = "_".join((backend, str(shards)) + tuple(e.strip("-") for e in extra))
    out = tmp_path / f"{tag}.paf"
    summary = serve_genomics.main(
        BASE_ARGS + ["--align-backend", backend, "--num-shards", str(shards),
                     *extra, "--out", str(out)])
    assert summary["align_backend"] == backend
    assert summary["mapped"] == 10
    return out.read_bytes()


@pytest.mark.parametrize("backend", ["torch", "cuda_dc", "cuda_dc_v2"])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_paf_matches_golden(tmp_path, shards, backend):
    """`repro_torch.shard` scatter/merge emits the 1-shard bytes: the
    merge rule does not depend on the layout and halo windows are
    byte-identical in both neighbours."""
    assert _run_sharded(tmp_path, backend, shards) == GOLDEN.read_bytes(), \
        f"PAF with --num-shards {shards} on {backend} diverged"


@pytest.mark.parametrize("shards,extra", [
    (2, ("--online", "--rate", "2000")),
    (3, ("--online", "--rate", "2000")),
    (2, ("--align-sharded",)),
    (3, ("--align-sharded",)),
    (2, ("--pipelined",)),
    (3, ("--pipelined",)),
    (2, ("--online", "--rate", "2000", "--align-sharded", "--pipelined")),
], ids=lambda v: "-".join(v) if isinstance(v, tuple) else str(v))
def test_sharded_modes_paf_matches_golden(tmp_path, shards, extra):
    """Online arrivals, per-shard align blocks and one flush in flight
    change the dispatch, not the bytes."""
    assert _run_sharded(tmp_path, "cuda_dc_v2", shards, *extra) == \
        GOLDEN.read_bytes(), f"PAF with --num-shards {shards} {extra} diverged"
