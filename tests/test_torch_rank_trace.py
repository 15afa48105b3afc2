"""The dry run's per-rank instruments (`repro_torch.launch.rank_trace`) on
hand-counted sequences of ops.

* ``LiveBytes``: tensors alive at the start, new storages, views (no new
  bytes), freed storages, DTensors (their local shard) — the live and
  peak byte counts by hand.
* ``CollectiveCounter``: functional collectives called directly on a
  fake process group of 8 ranks, mesh 2x2x2 ("pod", "data", "model"), on
  ``meta`` tensors — each op's kind, its result bytes on this rank, the
  mesh axes of its group, and the ring-weighted link bytes split into
  cross-pod (a group spanning "pod") and intra-pod; a DTensor's Partial
  to Replicate redistribution over "model", seen through DTensor (the
  mode lets DTensor run, then counts the collective it issues); the
  ``wait_tensor`` that follows a collective is not counted.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.rank_trace import CollectiveCounter, LiveBytes

F32 = 4


@pytest.fixture()
def mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                              device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_live_bytes_by_hand():
    held = torch.empty(25, device="meta")  # 100 bytes, alive at the start
    with LiveBytes([held]) as mem:
        assert (mem.live, mem.peak) == (100, 100)
        a = torch.empty(100, device="meta")  # +400: 500
        view = a.view(10, 10)  # a view: no new bytes
        b = torch.empty(50, device="meta")  # +200: 700
        assert (mem.live, mem.peak) == (700, 700)
        del a, view  # -400: 300
        assert mem.live == 300
        c = b + 1  # +200: 500, the peak stays 700
        assert (mem.live, mem.peak) == (500, 700)
        del b, c
        d = torch.empty(300, device="meta")  # 100 + 1,200 = 1,300
        assert (mem.live, mem.peak) == (1300, 1300)
    assert d.numel() == 300


def test_live_bytes_counts_a_dtensor_shard(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.empty(8, 4, device="meta"), mesh,
                          (Shard(0), Shard(0), Replicate()))  # [2, 4] here
    with LiveBytes([x]) as mem:
        assert mem.live == 2 * 4 * F32
        y = x * 2  # a new local shard
        assert mem.peak == 2 * (2 * 4 * F32)
    assert y.to_local().shape == (2, 4)


def test_collectives_by_hand(mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    c10d = torch.ops._c10d_functional
    pod, model = (mesh.get_group(a).group_name for a in ("pod", "model"))
    t = torch.empty(6, 4, device="meta")  # 96 bytes
    with CollectiveCounter(mesh) as coll:
        c10d.wait_tensor(c10d.all_gather_into_tensor(t, 2, pod))  # 192 B
        c10d.all_reduce(t, "sum", model)  # 96 B, ring x2
        c10d.reduce_scatter_tensor(t, "sum", 2, model)  # 48 B
        part = DTensor.from_local(torch.empty(10, device="meta"), mesh,
                                  (Replicate(), Replicate(), Partial()))
        part.redistribute(mesh, (Replicate(),) * 3)  # all_reduce, 40 B x2
    assert [(k, n, a) for k, n, a in coll.ops] == [
        ("all_gather", 192, ("pod",)), ("all_reduce", 96, ("model",)),
        ("reduce_scatter", 48, ("model",)), ("all_reduce", 40, ("model",))]
    got = coll.summary()
    assert got["n_ops"] == 4
    assert got["per_kind_bytes"] == {"all_gather": 192.0, "all_reduce": 136.0,
                                     "reduce_scatter": 48.0}
    assert got["cross_pod_bytes"] == 192.0
    assert got["intra_pod_bytes"] == 2 * 96 + 48 + 2 * 40
    assert got["link_bytes"] == got["cross_pod_bytes"] + got["intra_pod_bytes"]
    assert coll.axes_of(mesh.get_group("data").group_name) == ("data",)
