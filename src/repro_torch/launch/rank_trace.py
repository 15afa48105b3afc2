"""Rank 0's collectives and live bytes of a step run under a fake group.

The dry run (`launch/dryrun.py`) runs each cell's sharded step on
``meta`` tensors as rank 0 of a fake process group of 256 or 512 ranks
(`launch/mesh.fake_production_mesh`).  Two dispatch modes read that
run; both let DTensor run its ops (a mode runs before a tensor subclass;
on a DTensor op they return NotImplemented) and see the local ops and
collectives that DTensor makes of them, so what they count is rank 0's:

* ``CollectiveCounter``: every functional collective that the step's
  DTensors issue (``torch.ops._c10d_functional`` and its autograd
  twins: all_gather_into_tensor, all_reduce, reduce_scatter_tensor,
  all_to_all_single, broadcast, and the coalesced forms), with the bytes
  of its result on this rank, as the reference's `parse_collectives`
  reads a collective's result shape off the HLO, and the mesh axes its
  group spans (from the group's ranks against ``mesh.mesh``).  As in the
  reference, ``link_bytes`` weighs each kind by its ring factor (2 for
  an all-reduce, 1 otherwise), and splits into ``cross_pod_bytes`` (a
  group that spans "pod") and ``intra_pod_bytes``.
* ``LiveBytes``: the peak of the bytes of live storages.  The tensors
  handed to it when it opens (parameters, moments, batch, state) count
  from the start; every tensor an op makes counts from its creation
  until its storage is freed.  Views share their base's storage and
  count once; the fake tensors of DTensor's sharding propagation (the
  global shapes) do not count.

Neither mode changes what runs; both add Python work to every op, so a
step timed under them is slower than without.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
         "broadcast")
# bytes moved per link for a ring of each kind, per payload byte (the
# reference's `launch/roofline._RING_FACTOR`)
RING_FACTOR = {"all_reduce": 2.0}


def _kind(func) -> str | None:
    """A collective's kind (``all_gather_into_tensor_coalesced`` ->
    ``all_gather``; ``all_reduce_`` -> ``all_reduce``), or None for any
    other op (``wait_tensor`` and the like)."""
    if func.namespace not in COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    return next((k for k in KINDS if name.startswith(k)), None)


def _on_dtensors(types) -> bool:
    """An op on DTensors: the mode returns NotImplemented, so that DTensor
    runs it and its local ops and collectives come back through the
    mode (a mode runs before a tensor subclass)."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _nbytes(out) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(out) if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives run under it, by kind and by the
    mesh axes of their group.  ``mesh``: the DeviceMesh whose groups the
    collectives run on."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.ops: list[tuple[str, int, tuple[str, ...]]] = []
        self._axes: dict[str, tuple[str, ...]] = {}

    def axes_of(self, group_name: str) -> tuple[str, ...]:
        """The mesh axes along which a group's ranks differ."""
        if group_name not in self._axes:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import _resolve_process_group

            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
            grid = self.mesh.mesh
            coords = torch.stack([(grid == r).nonzero()[0] for r in ranks])
            self._axes[group_name] = tuple(
                a for d, a in enumerate(self.mesh.mesh_dim_names)
                if bool((coords[:, d] != coords[0, d]).any()))
        return self._axes[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind is not None:
            group = kwargs.get("group_name") or next(
                a for a in reversed(args) if isinstance(a, str))
            self.ops.append((kind, _nbytes(out), self.axes_of(group)))
        return out

    def summary(self) -> dict:
        """``n_ops``, ``per_kind_bytes`` and the ring-weighted
        ``link_bytes``, ``cross_pod_bytes`` and ``intra_pod_bytes``."""
        per_kind: dict[str, float] = {}
        cross = intra = 0.0
        for kind, nbytes, axes in self.ops:
            per_kind[kind] = per_kind.get(kind, 0.0) + nbytes
            link = nbytes * RING_FACTOR.get(kind, 1.0)
            if "pod" in axes:
                cross += link
            else:
                intra += link
        return {"n_ops": len(self.ops), "per_kind_bytes": per_kind,
                "link_bytes": cross + intra, "cross_pod_bytes": cross,
                "intra_pod_bytes": intra}


class LiveBytes(TorchDispatchMode):
    """The peak bytes of live storages while it is open; ``tensors`` are
    those alive when it opens (DTensors count their local shard)."""

    def __init__(self, tensors=()):
        super().__init__()
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self.track(t)

    def track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += self._sizes[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            # DTensor's sharding propagation runs each op on fake tensors
            # of the global shape: those hold no rank's bytes
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.track(t)
        return out
