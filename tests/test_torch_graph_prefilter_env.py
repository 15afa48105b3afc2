"""Port parity: ``REPRO_GRAPH_PREFILTER``, the graph mapper's environment
default for the q-gram tile screen.

With ``prefilter`` left at None, both packages resolve it from the
variable, on unless it is "0" (`repro.graph.mapper._env_prefilter`).
With the variable set to 0 (monkeypatched), the port's
``GraphMapExecutor`` and ``map_batch`` skip the screen as the
reference's do: the rows and the pruning counters equal the reference's
(tests/test_torch_graph_mapper.py's graph and reads).
"""
import numpy as np
import pytest

from repro.core.genasm import GenASMConfig as JConfig
from repro.graph import mapper as jmapper
from repro_torch.core.genasm import GenASMConfig
from repro_torch.graph import mapper as tmapper
from test_torch_graph_mapper import MAP_KW, assert_result_equal, setup  # noqa: F401


@pytest.mark.parametrize("value,on", [(None, True), ("1", True), ("0", False),
                                      ("no", True)])
def test_default_follows_the_variable(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("REPRO_GRAPH_PREFILTER", raising=False)
    else:
        monkeypatch.setenv("REPRO_GRAPH_PREFILTER", value)
    assert tmapper._env_prefilter(None) is jmapper._env_prefilter(None) is on
    assert tmapper._env_prefilter(True) is True
    assert tmapper._env_prefilter(False) is False


def test_prefilter_off_by_the_variable_matches_reference(setup, monkeypatch):  # noqa: F811
    monkeypatch.setenv("REPRO_GRAPH_PREFILTER", "0")
    _, jidx, tidx, arr, lens = setup
    jex = jmapper.GraphMapExecutor(tile_stride=jidx.tile_stride, cfg=JConfig(),
                                   backend="graph_lax", **MAP_KW)
    tex = tmapper.GraphMapExecutor(tile_stride=tidx.tile_stride,
                                   cfg=GenASMConfig(), backend="graph_torch",
                                   **MAP_KW)
    assert jex.prefilter is False and tex.prefilter is False
    want = jex(jidx.arrays, arr, lens)
    got = tex(tidx.arrays, arr, lens)
    assert_result_equal(got, want)
    assert tex.last_stats == jex.last_stats
    # the screen was skipped: every live tile went to the DC filter
    assert tex.last_stats["tiles_pruned"] == 0
    assert tex.last_stats["tiles_kept"] == tex.last_stats["tiles_live"] > 0
    got = tmapper.map_batch(tidx.arrays, arr, lens, tile_stride=tidx.tile_stride,
                            backend="graph_torch", **MAP_KW)
    want = jmapper.map_batch(jidx.arrays, arr, lens, tile_stride=jidx.tile_stride,
                             backend="graph_lax", **MAP_KW)
    assert_result_equal(got, want)
    assert np.asarray(want.position).shape == (arr.shape[0],)
