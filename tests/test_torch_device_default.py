"""Every genomics index constructor of the port, and the model zoo's and
the obs plane's, runs on the card unless the caller asks for the CPU.

One parametrised test over the functions whose default device is
``cuda``: with `torch.cuda.is_available` patched to False, a call with
no device raises a `RuntimeError` that names ``device='cpu'`` (nothing
falls back to the CPU); with ``device="cpu"`` the call gives what the
CPU path gave before the defaults moved, held against the reference
package where it has the function.
"""
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from repro.core import minimizer_index as jindex
from repro.core.segram import graph as jgraph
from repro.core.segram import minimizer as jmin
from repro.core.segram import segram as jseg
from repro.genomics import simulate
from repro.graph import index as jgindex
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core import minimizer_index as tindex
from repro_torch.core.genasm import GenASMConfig
from repro_torch.core.segram import graph as tgraph
from repro_torch.core.segram import minimizer as tmin
from repro_torch.core.segram import segram as tseg
from repro_torch.graph import index as tgindex
from repro_torch.graph import mapper as tgmapper
from repro_torch.models import model_zoo
from repro_torch.obs import RooflineManager
from repro_torch.shard import partition as tpartition

REF = simulate.random_reference(1500, seed=5)
VARIANTS = simulate.simulate_variants(REF, n_snp=6, n_ins=3, n_del=3, seed=6)
GKW = dict(w=8, k=12, window=192, tile_stride=64, margin=64)
CPU = torch.device("cpu")


def equal_arrays(got, want, fields) -> None:
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.device == CPU, name
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.astype(np.int64).astype(np.uint32) if g.dtype == np.int64 \
                else g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)


def linear_ref():
    return jindex.build_reference_index(REF, w=8, k=12)


def graph_ref():
    return jgindex.build_graph_index(REF, VARIANTS, **GKW)


def check_graph(got) -> None:
    want = graph_ref()
    assert got.tile_len == want.tile_len
    equal_arrays(got.arrays, want.arrays, want.arrays._fields)


def saved_graph(tmp_path):
    path = tmp_path / "g.npz"
    jgindex.save_graph_index(path, graph_ref())
    return path


def carried_graph(device=None):
    want = graph_ref()
    kw = {} if device is None else dict(device=device)
    return tgindex.graph_index_from_arrays(
        want.ref, jgindex.GraphArrays(*(np.asarray(x) for x in want.arrays)),
        tile_len=want.tile_len, tile_stride=want.tile_stride,
        minimizer_w=want.minimizer_w, minimizer_k=want.minimizer_k,
        window=want.window, margin=want.margin, **kw)


def segram_ref():
    return jseg.preprocess(REF, jgraph.build_graph(REF, VARIANTS), w=8, k=12)


def check_unmapped(got) -> None:
    assert got.position.device == CPU
    assert (got.position == -1).all() and (got.distance == -1).all()
    assert (got.n_ops == 0).all() and got.failed.all()
    assert got.ops.shape == (3, GenASMConfig().ops_cap(128))


def check_init(got) -> None:
    again = model_zoo.init(got.cfg, device="cpu")
    for (name, p), q in zip(got.named_parameters(), again.parameters()):
        assert p.device == CPU and torch.equal(p, q), name


def check_sharded(got) -> None:
    idx = linear_ref()
    assert got.devices == (CPU,)
    flat = np.concatenate([got.parts[0].hashes[i].numpy()
                           for i in range(got.num_shards)])
    kept = flat[flat != 0xFFFFFFFF]
    np.testing.assert_array_equal(np.sort(kept),
                                  np.sort(np.asarray(idx.hashes, np.int64)))


def check_roofline(got) -> None:
    assert got.device == "cpu" and got.spec.name == "cpu_host"


class Case(NamedTuple):
    name: str
    call: Callable  # (tmp_path, **device_kw) -> result
    check: Callable  # (result) -> None, asserts


CASES = [
    Case("minimizer_index.index_from_arrays",
         lambda tp, **kw: tindex.index_from_arrays(
             *(np.asarray(x) for x in linear_ref()), **kw),
         lambda got: equal_arrays(got, linear_ref(), ("ref", "hashes",
                                                      "positions"))),
    Case("minimizer_index.build_reference_index",
         lambda tp, **kw: tindex.build_reference_index(REF, w=8, k=12, **kw),
         lambda got: equal_arrays(got, linear_ref(), ("ref", "hashes",
                                                      "positions"))),
    Case("minimizer_index.build_epoched_index",
         lambda tp, **kw: tindex.build_epoched_index(REF, w=8, k=12, **kw),
         lambda got: equal_arrays(got.index, linear_ref(),
                                  ("ref", "hashes", "positions"))),
    Case("segram.minimizer.build_index",
         lambda tp, **kw: tmin.build_index(REF, w=8, k=12, **kw),
         lambda got: [np.testing.assert_array_equal(
             getattr(got, f), getattr(jmin.build_index(REF, w=8, k=12), f))
             for f in ("hashes", "positions", "freq_cap")]),
    Case("segram.index_from_arrays",
         lambda tp, **kw: tseg.index_from_arrays(
             *(np.asarray(x) for x in segram_ref()), **kw),
         lambda got: equal_arrays(got, segram_ref(), got._fields)),
    Case("segram.preprocess",
         lambda tp, **kw: tseg.preprocess(
             REF, tgraph.build_graph(REF, VARIANTS), w=8, k=12, **kw),
         lambda got: equal_arrays(got, segram_ref(), got._fields)),
    Case("graph.index.build_graph_index",
         lambda tp, **kw: tgindex.build_graph_index(REF, VARIANTS, **GKW, **kw),
         check_graph),
    Case("graph.index.graph_index_from_arrays",
         lambda tp, **kw: carried_graph(**kw), check_graph),
    Case("graph.index.load_graph_index",
         lambda tp, **kw: tgindex.load_graph_index(saved_graph(tp), **kw),
         check_graph),
    Case("graph.index.build_epoched_graph_index",
         lambda tp, **kw: tgindex.build_epoched_graph_index(
             REF, VARIANTS, **GKW, **kw),
         lambda got: check_graph(got.index)),
    Case("graph.mapper.unmapped_result",
         lambda tp, **kw: tgmapper.unmapped_result(3, cfg=GenASMConfig(),
                                                   p_cap=128, **kw),
         check_unmapped),
    Case("shard.partition.build_sharded_index",
         lambda tp, **kw: tpartition.build_sharded_index(
             REF, 2, w=8, k=12,
             **({"devices": (kw["device"],)} if kw else {})),
         check_sharded),
    Case("models.model_zoo.init",
         lambda tp, **kw: model_zoo.init(
             reduced(get_config("yi-6b"), n_layers=1, d_model=64, n_heads=2,
                     n_kv_heads=1, d_ff=128, vocab=128), **kw),
         check_init),
    Case("obs.RooflineManager",
         lambda tp, **kw: RooflineManager(**kw), check_roofline),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_default_device_is_the_card(case, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        case.call(tmp_path)
    case.check(case.call(tmp_path, device="cpu"))


def test_backend_names_still_follow_the_device(monkeypatch):
    """`resolve_backend` and `graph_backend_name` only pick a name, and
    keep their CPU default."""
    from repro_torch.align import resolve_backend

    monkeypatch.delenv("REPRO_ALIGN_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_backend(None).name == "torch"
    assert resolve_backend(None, "cuda").name == "cuda_dc"
    assert tgmapper.graph_backend_name(None) == "graph_torch"
    assert tgmapper.graph_backend_name(None, "cuda") == "graph_cuda"
