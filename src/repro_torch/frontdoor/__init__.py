"""Front door: the schema'd v5 snapshot container of session state.

Only the session half of :mod:`~repro_torch.frontdoor.snapshot_v5` is in
this package yet; the multi-tenant gateway, its admission control and
worker leases (and the gateway envelope of the container) are ROADMAP
queue A, slice 7.
"""

from repro_torch.frontdoor.snapshot_v5 import (SNAPSHOT_MAGIC,
                                               decode_snapshot,
                                               encode_snapshot,
                                               is_v5_snapshot)

__all__ = ["encode_snapshot", "decode_snapshot", "is_v5_snapshot",
           "SNAPSHOT_MAGIC"]
