"""Production meshes: ``torch.distributed`` device meshes over a fake
process group.

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
data=16, model=16) = 512; only data parallelism (the gradient reduction)
and expert parallelism cross the ``pod`` axis.  The JAX package builds its
meshes over 512 placeholder host devices; here a *fake* process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once with a tensor of the right shape, nothing is sent) stands
in for 256 or 512 ranks, and this process acts as rank 0.  A production
case allocates nothing on any device, so the mesh's device type is
``"cpu"`` on a machine with a card too.

Importing this module touches no process-group state: the group exists
only inside :func:`production_mesh` (or :func:`fake_process_group`), which
destroys it on exit, whatever happens inside.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

import torch.distributed as dist

__all__ = ["mesh_axes", "mesh_shape", "make_production_mesh",
           "production_mesh", "fake_process_group"]

_FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def mesh_axes(*, multi_pod: bool = False) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def mesh_shape(*, multi_pod: bool = False) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks with this process as
    ``rank``, destroyed on exit.  Refuses to run inside another group.
    Raises naming the internal module that provides the fake backend when
    this PyTorch lacks it (there is no other backend to fall back to)."""
    try:
        from torch.testing._internal.distributed import fake_pg
    except ImportError as e:
        raise RuntimeError(
            f"the production meshes need PyTorch's fake process group "
            f"({_FAKE_PG}), which this PyTorch lacks") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "production mesh makes its own fake one")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the current process
    group, which must have exactly that many ranks (open it with
    :func:`production_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = mesh_shape(multi_pod=multi_pod)
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        raise RuntimeError(
            f"make_production_mesh needs a process group of "
            f"{math.prod(shape)} ranks: open one with production_mesh()")
    return init_device_mesh("cpu", shape,
                            mesh_dim_names=mesh_axes(multi_pod=multi_pod))


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False) -> Iterator[object]:
    """``with production_mesh() as mesh:`` — the fake group of 256 (512)
    ranks and its production mesh; the group is destroyed on exit."""
    with fake_process_group(math.prod(mesh_shape(multi_pod=multi_pod))):
        yield make_production_mesh(multi_pod=multi_pod)
