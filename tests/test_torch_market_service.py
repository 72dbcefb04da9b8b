"""The port's market pool in its scheduler service against the JAX
package's, on the CPU: the post-round seams (the optimiser, indicative
gang prices, the idealised and realised value) and the bid refresh.

Both services get the same jobs (`parallel/scenarios.market_inputs`, every
eighth single job bidding through price band B), the same config
(`workload.market_service_config`: the optimiser on, two gang shapes
priced with a deadline no shape reaches) and the same bid provider
(`workload.StepBidProvider`, band B raised after the second fetch),
carried to the reference (`torch_control_plane.to_reference`). Under the
"oracle" and the "kernel" backend, cycle by cycle, they lease and
preempt alike and report the same spot price, indicative prices, and
idealised and realised values per queue; the third cycle's refresh
re-prices jobs on both. `workload.MarketServiceRun`, chip_smoke.py's
market harness, runs the same pool on the "cuda" and "lax" paths and on
the host oracle alike.
"""

import dataclasses

import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.parallel.scenarios import market_inputs
from armada_tpu_torch.services.pricing import PRICE_BAND_ANNOTATION
from armada_tpu_torch.workload import (
    BAND_B_EVERY,
    MarketServiceRun,
    StepBidProvider,
    market_service_config,
)
from torch_control_plane import PORT, REF, leases_view, plain, to_reference

N_NODES, N_JOBS = 16, 384


class _CarriedProvider:
    """A port bid provider whose snapshots the reference service reads."""

    def __init__(self, provider):
        self.provider = provider

    def get_bid_prices(self):
        return to_reference(self.provider.get_bid_prices())


def _stack(pkg, backend):
    cfg, pool, _, queues, _, queued = market_inputs(N_NODES, N_JOBS)
    cfg = market_service_config("lax")
    jobs = [
        job.with_(annotations={PRICE_BAND_ANNOTATION: "B"})
        if job.gang is None and i % BAND_B_EVERY == 3 else job
        for i, job in enumerate(queued)
    ]
    provider = StepBidProvider([q.name for q in queues], pool)
    if pkg is REF:
        cfg, queues, jobs = to_reference((cfg, queues, jobs))
        provider = _CarriedProvider(provider)
    log = pkg.InMemoryEventLog()
    sched = pkg.SchedulerService(cfg, log, backend=backend, bid_price_provider=provider)
    submit = pkg.SubmitService(cfg, log, scheduler=sched)
    for q in queues:
        submit.create_queue(q)
    for q in queues:
        submit.submit(q.name, "market", [j for j in jobs if j.queue == q.name], now=0.0)
    executors = [
        pkg.FakeExecutor(f"ex-{k}", log, sched,
                         nodes=pkg.make_nodes(f"ex-{k}", count=N_NODES // 2, pool=pool,
                                              cpu="16", memory="64Gi"),
                         runtime_for=lambda job_id: 3600.0)
        for k in range(2)
    ]
    return sched, executors, pool


def _history(pkg, backend):
    sched, executors, pool = _stack(pkg, backend)
    out = []
    for t in (0.0, 10.0, 20.0):
        for ex in executors:
            ex.tick(t)
        sched.cycle(now=t)
        rep = sched.reports.latest_reports()[pool]
        out.append({
            "leases": leases_view(sched.jobdb),
            "spot_price": rep.spot_price,
            "indicative": plain(rep.indicative_prices),
            "values": {q: (r.idealised_value, r.realised_value) for q, r in rep.queues.items()},
            "bids": sorted((j.id, tuple(sorted(j.spec.bid_prices.items())))
                           for j in sched.jobdb.read_txn().all_jobs()),
        })
    return out


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_market_service_equals_reference(backend):
    port = _history(PORT, backend)
    ref = _history(REF, backend)
    for i, (p, r) in enumerate(zip(port, ref)):
        assert p == r, f"cycle {i}"
    leased = [sum(run is not None and run[4] == "leased" for _, _, run in h["leases"].values())
              for h in port]
    assert leased[0] > 0
    assert all(h["indicative"] and h["values"] for h in port)
    for h in port:
        for _, shape in h["indicative"].items():
            assert dict(shape[1:])["evaluated"], shape  # no shape timed out
    # Band B's price rose after the second fetch: its jobs' bids moved.
    assert port[2]["bids"] != port[1]["bids"]


def test_market_service_run_cuda_path_equals_lax_path():
    """chip_smoke.py's market harness at a small size: the "cuda" and
    "lax" services, and the host oracle's that the smoke holds the card's
    to, give the same leases, preemptions and market report cycle by
    cycle; the third cycle's refresh re-prices band B."""
    hist = {}
    for backend, path, rung in (("kernel", "cuda", "local:cuda"), ("kernel", "lax", "LOCAL"),
                                ("oracle", "cuda", "oracle")):
        run = MarketServiceRun(N_NODES, N_JOBS, backend=backend, kernel_path=path, device="cpu")
        recs = [run.cycle() for _ in range(3)]
        hist[rung] = [(r["leases"], r["preempted"], r["market"]) for r in recs]
        assert recs[0]["leases"] and recs[2]["market"]["repriced"] > 0
        assert all(r["stats"]["rung"] == rung for r in recs)
        assert all(s["evaluated"] for r in recs for s in r["market"]["indicative"].values())
    assert hist["local:cuda"] == hist["LOCAL"] == hist["oracle"]


def test_market_config_carries_across():
    """The market service's config, bid snapshot and pricing results
    carry to the reference and back (`utils.carry.to_port`)."""
    from armada_tpu_torch.solver.pricer import GangPricingResult
    from armada_tpu_torch.utils.carry import to_port

    cfg = market_service_config()
    snap = StepBidProvider(["m0"], "market").get_bid_prices()
    priced = GangPricingResult(evaluated=True, schedulable=True, price=4.5)
    for value in (cfg, snap, priced):
        ref = to_reference(value)
        assert type(ref).__module__.startswith("armada_tpu.")
        assert to_port(ref) == value
    assert dataclasses.asdict(to_reference(snap)) == dataclasses.asdict(snap)
