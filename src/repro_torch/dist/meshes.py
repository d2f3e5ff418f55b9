"""Worker meshes: the device-set descriptor behind a dispatcher worker.

The paper's workers are GPU *servers* — a stage runs on a set of devices,
not a thread.  A :class:`WorkerMesh` is the picklable descriptor of one
worker's device set: the CUDA device ids it owns, the named axis layout
over them, the :class:`~repro_torch.dist.sharding.ShardingRules` preset
mapping placement roles onto those axes, and the host the devices are
attached to (the dispatcher's device-to-device handoff is host-local;
cross-host resumes fall back to the checkpoint store).

The descriptor is deliberately inert — nothing touches a device at
construction, so session snapshots can pickle it and the simulator can
schedule against capacities that do not exist locally.  Only
:meth:`WorkerMesh.torch_devices` touches the runtime.

Compatibility is the divisibility gate: a worker can host a sharded stage
when at least one parameter dimension divides its shard axes
(:func:`repro_torch.dist.sharding.generic_param_specs`); a mesh nothing
shards on is rejected by placement (``EngineStats.placement_rejections``)
so the scheduler keeps it for work it can actually accelerate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.dist.sharding import ShardingRules

__all__ = ["WorkerMesh", "plan_worker_meshes"]


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """One worker's device set (see module docstring).

    ``axes`` is the named layout over ``device_ids`` in row-major order —
    ``(("data", 4),)`` is a flat 4-device FSDP mesh, ``(("data", 2),
    ("model", 2))`` a 2×2 FSDP×TP mesh.  The axis-size product must equal
    ``len(device_ids)``.
    """

    device_ids: Tuple[int, ...]
    axes: Tuple[Tuple[str, int], ...]
    rules: ShardingRules
    host: str = "host0"

    def __post_init__(self):
        if not self.device_ids:
            raise ValueError("a WorkerMesh needs at least one device")
        prod = math.prod(n for _, n in self.axes) if self.axes else 1
        if prod != len(self.device_ids):
            raise ValueError(
                f"axis sizes {dict(self.axes)} cover {prod} devices but the "
                f"mesh owns {len(self.device_ids)}")

    # ------------------------------------------------------------ inspection
    @property
    def n_devices(self) -> int:
        return len(self.device_ids)

    @property
    def sizes(self) -> Dict[str, int]:
        """Axis-name → size mapping (the divisibility gate's ``sizes``)."""
        return dict(self.axes)

    @property
    def key(self) -> Tuple:
        """Stable hashable identity (caches are keyed by it)."""
        return (self.device_ids, self.axes, self.host)

    # --------------------------------------------------------------- runtime
    def torch_devices(self):
        """The mesh's CUDA devices, in ``device_ids`` order — the only
        method that touches the runtime.  Raises ``ValueError`` when an id
        is not visible to this process."""
        import torch

        n = torch.cuda.device_count()
        missing = [i for i in self.device_ids if i >= n]
        if missing:
            raise ValueError(
                f"mesh device ids {missing} exceed the {n} visible CUDA "
                "devices")
        return [torch.device("cuda", i) for i in self.device_ids]

    # ---------------------------------------------------------- construction
    @classmethod
    def build(cls, device_ids: Sequence[int],
              axes: Optional[Sequence[Tuple[str, int]]] = None,
              rules: Optional[ShardingRules] = None,
              host: str = "host0") -> "WorkerMesh":
        """Descriptor with the production defaults: a flat ``data`` axis
        over the devices and the single-pod :meth:`ShardingRules.for_mesh`
        preset (FSDP over ``data``, TP over ``model`` when present)."""
        ids = tuple(int(i) for i in device_ids)
        if axes is None:
            axes = (("data", len(ids)),)
        axes = tuple((str(n), int(s)) for n, s in axes)
        if rules is None:
            rules = ShardingRules.for_mesh(
                multi_pod=any(n == "pod" for n, _ in axes))
        return cls(device_ids=ids, axes=axes, rules=rules, host=host)


def plan_worker_meshes(n_workers: int, devices_per_worker: int,
                       host: str = "host0",
                       rules: Optional[ShardingRules] = None
                       ) -> Tuple[Optional[WorkerMesh], ...]:
    """Homogeneous worker fleet: ``n_workers`` meshes of consecutive
    ``devices_per_worker``-device blocks on one host.  ``devices_per_worker
    <= 0`` yields all-``None`` (plain thread workers)."""
    if devices_per_worker <= 0:
        return tuple(None for _ in range(n_workers))
    return tuple(
        WorkerMesh.build(
            range(w * devices_per_worker, (w + 1) * devices_per_worker),
            rules=rules, host=host)
        for w in range(n_workers))
