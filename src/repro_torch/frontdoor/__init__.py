"""Front door: multi-tenant study gateway over the service plane.

``StudyGateway`` routes continuously-arriving studies from many tenants
to per-plan-key :class:`~repro_torch.core.study.StudyService` sessions,
applies per-tenant weighted fair-share admission control, leases one
worker fleet across every live session, and persists the whole deployment
as one schema'd v5 snapshot.  See :mod:`repro_torch.frontdoor.gateway`.
"""

from repro_torch.frontdoor.admission import (AdmissionController,
                                             AdmissionQueueFull,
                                             CapacityError, Submission,
                                             TenantQuota)
from repro_torch.frontdoor.gateway import GatewayFuture, StudyGateway
from repro_torch.frontdoor.leases import Lease, WorkerLeaseManager
from repro_torch.frontdoor.snapshot_v5 import (SNAPSHOT_MAGIC, GatewayState,
                                               decode_snapshot,
                                               encode_snapshot,
                                               is_v5_snapshot)

__all__ = [
    "StudyGateway", "GatewayFuture",
    "AdmissionController", "TenantQuota", "Submission",
    "AdmissionQueueFull", "CapacityError",
    "WorkerLeaseManager", "Lease",
    "GatewayState", "encode_snapshot", "decode_snapshot", "is_v5_snapshot",
    "SNAPSHOT_MAGIC",
]
