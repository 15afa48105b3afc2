"""Production mesh construction.

Port of `repro.launch.mesh`.  ``make_production_mesh`` is a function
(never a module-level constant), so importing this module touches no
process group.  Single pod: 16×16 = 256 cards ("data", "model");
multi-pod: 2×16×16 = 512 cards ("pod", "data", "model") — the "pod"
axis is the cross-pod axis.  A DeviceMesh needs a process group of as
many ranks as the mesh has cards.

``mesh_shape`` is a helper the reference lacks: a plain named-size
mapping that `repro_torch.dist.sharding` accepts wherever it accepts a
mesh.  The dry run resolves the production meshes' specs with it.

``fake_production_mesh`` is the other: the production mesh on the CPU
over PyTorch's ``fake`` process group, this process as rank 0 of 256 or
512 ranks (JAX fakes 512 host devices instead).  Collectives on it
return at once and move no data, so a step on ``meta`` tensors runs
rank 0's ops, shapes and collectives.  One such group exists at a time
in a process.
"""
from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_shape(shape, axes) -> dict[str, int]:
    """``{axis: size}`` of a mesh of ``shape`` named ``axes``."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    return dict(zip(axes, (int(s) for s in shape)))


def production_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh as a named-size mapping."""
    return mesh_shape(*PRODUCTION[multi_pod])


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group (which needs as many ranks as the mesh has devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_debug_mesh(*PRODUCTION[multi_pod], device_type=device_type)


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh on ``cpu``, this process rank 0 of a fake
    process group of as many ranks: the group is initialised on entry and
    destroyed on exit (a process with a group of its own raises)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: the fake production "
                           "mesh needs a process of its own")
    shape, axes = PRODUCTION[multi_pod]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield make_debug_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes (batch sharding)."""
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"
