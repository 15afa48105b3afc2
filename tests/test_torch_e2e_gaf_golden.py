"""Golden end-to-end regression for the port's graph workload: its
service emits the reference's GAF byte for byte.

Runs `repro_torch.launch.serve_genomics --mode graph` (simulate →
variation-graph index → engine → GAF) with the `BASE_ARGS` of
tests/test_e2e_gaf_golden.py on the CPU (``--device cpu``) and asserts
the written GAF equals the committed ``tests/data/serve_graph_golden.gaf``
— offline and ``--online``, on the ``graph_torch`` backend and on
``graph_cuda``, whose kernel wrapper runs its plain version on the CPU.
"""
import pathlib

import pytest

from repro_torch.launch import serve_genomics

GOLDEN = pathlib.Path(__file__).parent / "data" / "serve_graph_golden.gaf"
BASE_ARGS = [
    "--mode", "graph", "--ref-len", "3000", "--reads", "10",
    "--read-len", "100", "--batch", "4", "--buckets", "128",
    "--device", "cpu",
]


@pytest.mark.parametrize("online", [False, True], ids=["offline", "online"])
@pytest.mark.parametrize("backend", ["graph_torch", "graph_cuda"])
def test_gaf_matches_golden(tmp_path, backend, online):
    out = tmp_path / f"{backend}{'_online' if online else ''}.gaf"
    argv = BASE_ARGS + ["--align-backend", backend, "--out", str(out)]
    if online:
        argv += ["--online", "--rate", "2000"]
    summary = serve_genomics.main(argv)
    assert summary["align_backend"] == backend
    assert summary["mapped"] == 10
    assert out.read_bytes() == GOLDEN.read_bytes(), \
        f"GAF for backend {backend} (online={online}) diverged from the snapshot"


def test_linear_names_serve_their_graph_twins(tmp_path):
    out = tmp_path / "twin.gaf"
    summary = serve_genomics.main(BASE_ARGS + ["--align-backend", "cuda_dc_v2",
                                               "--out", str(out)])
    assert summary["align_backend"] == "graph_cuda"
    assert out.read_bytes() == GOLDEN.read_bytes()


def test_one_setup_serves_runs_with_their_own_engine_settings(tmp_path,
                                                              monkeypatch):
    """`serve` runs the engine with its own arguments' batch, flush
    deadline and backend, and refuses arguments the index was not built
    for."""
    seen = []

    class Recording(serve_genomics.ServeEngine):
        def __init__(self, index, config, **kw):
            seen.append(config)
            super().__init__(index, config, **kw)

    monkeypatch.setattr(serve_genomics, "ServeEngine", Recording)
    svc = serve_genomics.setup(serve_genomics.parse_args(BASE_ARGS))
    out = tmp_path / "deadline.gaf"
    args = serve_genomics.parse_args(BASE_ARGS + [
        "--online", "--rate", "2000", "--max-delay-ms", "20", "--batch", "3",
        "--align-backend", "graph_torch", "--out", str(out)])
    summary = serve_genomics.serve(svc, args)
    assert (seen[-1].max_delay_s, seen[-1].max_batch,
            seen[-1].align_backend) == (0.02, 3, "graph_torch")
    assert summary["mapped"] == 10
    assert out.read_bytes() == GOLDEN.read_bytes()
    with pytest.raises(ValueError, match="own setup"):
        serve_genomics.serve(svc, serve_genomics.parse_args(
            BASE_ARGS + ["--buckets", "160"]))


def _run_sharded(tmp_path, backend: str, shards: int, *extra: str) -> bytes:
    out = tmp_path / f"{backend}_{shards}.gaf"
    summary = serve_genomics.main(
        BASE_ARGS + ["--align-backend", backend, "--num-shards", str(shards),
                     *extra, "--out", str(out)])
    assert summary["align_backend"] == backend
    assert summary["mapped"] == 10
    return out.read_bytes()


@pytest.mark.parametrize("backend", ["graph_torch", "graph_cuda"])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_gaf_matches_golden(tmp_path, shards, backend):
    """`repro_torch.shard`'s graph half (tile/backbone partition, device
    merge) emits the 1-shard GAF bytes."""
    assert _run_sharded(tmp_path, backend, shards) == GOLDEN.read_bytes(), \
        f"GAF with --num-shards {shards} on {backend} diverged"


@pytest.mark.parametrize("extra", [("--online", "--rate", "2000"),
                                   ("--align-sharded",), ("--pipelined",)],
                         ids=["online", "align_sharded", "pipelined"])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_modes_gaf_matches_golden(tmp_path, shards, extra):
    """Online arrivals, per-shard align blocks and one flush in flight
    change the dispatch, not the GAF bytes."""
    assert _run_sharded(tmp_path, "graph_cuda", shards, *extra) == \
        GOLDEN.read_bytes(), f"GAF with --num-shards {shards} {extra} diverged"
