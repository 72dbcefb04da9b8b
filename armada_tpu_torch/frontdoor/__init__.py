"""Overload-hardened front door: sharded ingest + tenant admission.

The submit path at scale: jobset-keyed N-way sharded
ingest WALs with ordered, exactly-once delivery into the main event log
(`partition.py` — the Pulsar-partitioning analogue), per-tenant
token-bucket admission with quota-weighted overload shedding in front of
the backpressure stack (`admission.py`), and submit-wire deadline
propagation (expired work drops early, acked work always applies).
`tools/frontdoor_soak.py` is the chaos-soaked SLO gate over the whole
path.

This is the port's copy of the JAX package's frontdoor/ package (host
Python: no solve runs in it). The gRPC transport that maps its errors
to RESOURCE_EXHAUSTED waits for the server's port (ROADMAP A2).
"""

from .admission import (
    AdmissionError,
    DeadlineExpired,
    TenantAdmission,
    TokenBucket,
)
from .partition import FrontDoor, IngestShard, ShardCrashed, shard_of

__all__ = [
    "AdmissionError",
    "DeadlineExpired",
    "FrontDoor",
    "IngestShard",
    "ShardCrashed",
    "TenantAdmission",
    "TokenBucket",
    "shard_of",
]
