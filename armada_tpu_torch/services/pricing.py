"""Bid-price provider: per-(queue, band, pool) bids feeding market mode.

The reference's pricing layer (internal/scheduler/pricing/{types,bid_service,
bid_price,client}.go and pkg/bidstore) supplies each job's bid from a
periodically refreshed snapshot keyed by (queue, price band): jobs carry a
price band (an annotation-sized enum, bidstore/util.go:21-44), the provider
returns a `BidPriceSnapshot`, and the scheduler re-prices exactly the jobs
whose (queue, band) key changed between snapshots (scheduler.go:540-585).

Re-designed here as plain host-side data flow: the provider interface is a
single `get_bid_prices()` returning an immutable snapshot; diffing and job
re-pricing are pure functions over the jobdb, so they compose with the
event-sourced restart story (bids are NOT event-sourced — like the
reference, a restarted scheduler simply re-fetches from the provider).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field

from ..snapshot.round import NON_PREEMPTIBLE_RUNNING_PRICE  # re-export

# Price bands (pkg/bidstore PriceBand; short names from bidstore/util.go).
PRICE_BAND_UNSPECIFIED = 0
PRICE_BANDS: dict[str, int] = {
    "None": PRICE_BAND_UNSPECIFIED,
    **{chr(ord("A") + i): i + 1 for i in range(8)},  # A..H = 1..8
}
PRICE_BAND_NAMES = {v: k for k, v in PRICE_BANDS.items()}

PRICE_BAND_ANNOTATION = "armadaproject.io/priceBand"

__all__ = [
    "Bid",
    "BidPriceSnapshot",
    "ExternalBidPriceService",
    "LocalBidPriceService",
    "NON_PREEMPTIBLE_RUNNING_PRICE",  # single source: snapshot/round.py
    "NoopBidPriceProvider",
    "PRICE_BANDS",
    "job_price_band",
    "refresh_job_bids",
]


def job_price_band(spec) -> int:
    """Band a submitted job bid into (jobdb job.GetPriceBand); unknown or
    absent annotations fall back to UNSPECIFIED rather than erroring — a
    malformed job must not break the pricing refresh."""
    raw = str(spec.annotations.get(PRICE_BAND_ANNOTATION, "None"))
    return PRICE_BANDS.get(raw, PRICE_BANDS.get(raw.upper(), PRICE_BAND_UNSPECIFIED))


@dataclass(frozen=True)
class Bid:
    """Queued/running phase bids (pricing.Bid)."""

    queued: float = 0.0
    running: float = 0.0


@dataclass(frozen=True)
class BidPriceSnapshot:
    """One provider fetch (pricing.BidPriceSnapshot): bids keyed by
    (queue, band) -> {pool: Bid}. Two snapshots with the same id hold
    identical bids."""

    id: str
    timestamp: float
    bids: dict = field(default_factory=dict)  # {(queue, band): {pool: Bid}}
    resource_units: dict = field(default_factory=dict)  # {pool: {res: qty}}

    def get_price(self, queue: str, band: int):
        return self.bids.get((queue, band))

    def changed_price_keys(self, previous: "BidPriceSnapshot | None") -> set:
        """Keys added, removed, or re-priced vs `previous`
        (types.go ChangedPriceKeys)."""
        prev = previous.bids if previous is not None else {}
        changed = {k for k, v in self.bids.items() if prev.get(k) != v}
        changed |= {k for k in prev if k not in self.bids}
        return changed


class NoopBidPriceProvider:
    """Market mode off / no provider configured (pricing.NoopBidPriceProvider)."""

    def get_bid_prices(self) -> BidPriceSnapshot:
        return BidPriceSnapshot(id=uuid.uuid4().hex, timestamp=time.time())


class LocalBidPriceService:
    """Deterministic in-process provider (pricing.LocalBidPriceService):
    every queue bids band+1 in every pool, both phases — enough to exercise
    the full market path without an external bid store."""

    def __init__(self, pools: list[str], queues):
        self.pools = list(pools)
        self._queues = queues  # callable -> iterable of queue names

    def get_bid_prices(self) -> BidPriceSnapshot:
        bids = {}
        for queue in self._queues():
            for band in PRICE_BANDS.values():
                bids[(queue, band)] = {
                    pool: Bid(float(band) + 1.0, float(band) + 1.0)
                    for pool in self.pools
                }
        return BidPriceSnapshot(
            id=uuid.uuid4().hex, timestamp=time.time(), bids=bids
        )


class ExternalBidPriceService:
    """Adapter over a remote bid store (pricing.ExternalBidPriceService +
    bidstore client). `client` is any object with retrieve_bids() returning

        {"queue_bids": {queue: {pool: {band(int|str): {"queued": x,
                                                       "running": y}}}},
         "fallback":   {queue: {pool: {"queued": x, "running": y}}},
         "pool_resource_units": {pool: {resource: qty}}}

    Bands absent from a queue/pool fall back to the queue's fallback bids
    per phase (bid_service.go:124-141 getPrice). Transport errors propagate
    to the caller, which keeps the previous snapshot."""

    def __init__(self, client):
        self.client = client

    def get_bid_prices(self) -> BidPriceSnapshot:
        resp = self.client.retrieve_bids()
        bids = {}
        fallback = resp.get("fallback", {})
        for queue, pool_bids in resp.get("queue_bids", {}).items():
            for band in PRICE_BANDS.values():
                per_pool = {}
                for pool, band_bids in pool_bids.items():
                    # Probe int key, JSON-stringified int key (this repo's
                    # gRPC encoding stringifies int dict keys), then name.
                    bb = band_bids.get(
                        band,
                        band_bids.get(
                            str(band), band_bids.get(PRICE_BAND_NAMES[band])
                        ),
                    )
                    fb = fallback.get(queue, {}).get(pool, {})
                    queued = _phase(bb, fb, "queued")
                    running = _phase(bb, fb, "running")
                    if queued is not None or running is not None:
                        per_pool[pool] = Bid(queued or 0.0, running or 0.0)
                if per_pool:
                    bids[(queue, band)] = per_pool
        return BidPriceSnapshot(
            id=resp.get("id", uuid.uuid4().hex),
            timestamp=time.time(),
            bids=bids,
            resource_units={
                p: dict(r)
                for p, r in resp.get("pool_resource_units", {}).items()
            },
        )


def _phase(band_bid, fallback, phase: str):
    if band_bid is not None and phase in band_bid:
        return float(band_bid[phase])
    if fallback and phase in fallback:
        return float(fallback[phase])
    return None


def refresh_job_bids(
    jobdb,
    snapshot: BidPriceSnapshot,
    previous: BidPriceSnapshot | None,
    new_job_ids=(),
) -> int:
    """Apply a new snapshot to the job store: only jobs whose (queue, band)
    price actually changed are touched (scheduler.go:542-577). Returns the
    number of jobs re-priced. Bids are written as {pool: (queued, running)}
    pairs via fresh immutable specs through a write txn (never mutated in
    place — the spec object is shared with API threads serializing job
    details); JobSpec.bid_price resolves the phase at snapshot build time."""
    changed = snapshot.changed_price_keys(previous)
    if not changed and not new_job_ids:
        return 0
    txn = jobdb.write_txn()
    changed_queues = {queue for queue, _ in changed}
    # Indexed walk: queued jobs per changed queue + the leased set — never
    # the whole store (terminal jobs need no re-pricing). `new_job_ids`
    # (jobs submitted since the last refresh, tracked by the caller) are
    # priced from the current snapshot regardless of the diff, or a job
    # arriving under stable prices would sort at bid 0 forever.
    candidates = [
        job
        for queue in changed_queues
        for job in txn.queued_jobs(queue, sort=False)
    ] + [job for job in txn.leased_jobs() if job.queue in changed_queues]
    seen = {job.id for job in candidates}
    for job_id in new_job_ids:
        job = txn.get(job_id)
        if job is not None and not job.state.terminal and job.id not in seen:
            candidates.append(job)
    updated = []
    for job in candidates:
        key = (job.queue, job_price_band(job.spec))
        if key not in changed and job.spec.bid_prices:
            continue
        bids = snapshot.bids.get(key)
        if bids is None:
            # Key vanished from the new snapshot: keep the stale price
            # (the reference leaves these in place too, scheduler.go:565).
            continue
        updated.append(
            job.with_(
                spec=job.spec.with_(
                    bid_prices={
                        pool: (bid.queued, bid.running)
                        for pool, bid in bids.items()
                    }
                )
            )
        )
    if updated:
        txn.upsert(*updated)
    txn.commit()
    return len(updated)
