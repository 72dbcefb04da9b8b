"""Fairness-optimising post-pass (the reference's experimental optimiser).

Mirrors internal/scheduler/scheduling/optimiser/
{gang_scheduler,node_scheduler,preemption_info,scheduling_result}.go and
scheduling/optimising_queue_scheduler.go, invoked from
preempting_queue_scheduler.go:659-702: after the main round, walk
still-unscheduled gangs of queues BELOW their fair share in candidate
order and try to place them by preempting bound jobs, but only when the
fairness gain clears the configured improvement threshold.

Host-side by design: the pass is flag-gated, bounded (maximumJobsPerRound,
fraction caps, per-queue lookback) and touches a handful of gangs per
round, so it stays NumPy on the host while the main round runs on the
card — the same split the reference makes between its hot QueueScheduler
loop and this experimental extra pass.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from ..core.config import OptimiserConfig
from ..snapshot.round import RoundSnapshot

__all__ = ["OptimiserConfig", "OptimiserDecision", "optimise_round"]


@dataclass
class OptimiserDecision:
    """One gang placed by the optimiser."""

    scheduled: dict  # job index -> node index
    preempted: list  # job indices preempted to make room


def _round8(x: float) -> float:
    """roundFloatHighPrecision (node_scheduler.go:244-246)."""
    return round(x * 1e8) / 1e8


def static_feasible(snap: RoundSnapshot, j: int, n: int) -> bool:
    """StaticJobRequirementsMet (nodematching.go:161-190) for the optimiser
    (home scheduling only: no away tolerations here)."""
    if not snap.job_possible[j] or snap.node_unschedulable[n]:
        return False
    if n in snap.job_excluded_nodes[j]:
        return False
    a = snap.job_affinity_group[j]
    if a >= 0 and not (
        (snap.affinity_allowed[a, n // 32] >> np.uint32(n % 32)) & np.uint32(1)
    ):
        return False
    if (snap.node_taint_bits[n] & ~snap.job_tolerated[j]).any():
        return False
    if (snap.job_selector[j] & ~snap.node_label_bits[n]).any():
        return False
    req_fit = np.where(snap.floating_mask, 0, snap.job_req[j])
    return bool((req_fit <= snap.node_total[n]).all())


class _State:
    """Mutable optimiser view over the post-solve round."""

    def __init__(self, snap: RoundSnapshot, out: dict):
        self.snap = snap
        self.assigned = np.asarray(out["assigned_node"]).astype(np.int64).copy()
        self.sched_mask = np.asarray(out["scheduled_mask"]).copy()
        self.preempt_mask = np.asarray(out["preempted_mask"]).copy()
        self.sched_prio = np.asarray(out["scheduled_priority"]).astype(np.int64).copy()
        self.fair_share = np.asarray(out["demand_capped_fair_share"]).copy()
        mult = snap.drf_multipliers()
        total = snap.total_resources.astype(np.float64)
        safe = np.where(total > 0, total, 1.0)
        self._cost = lambda vec: float(
            np.max(np.where(total > 0, vec / safe, 0.0) * mult, initial=0.0)
        )
        self.req_fit = snap.job_req_fit()
        # Real free space + victim list per node: the optimiser preempts
        # explicitly rather than using priority rows (node_scheduler.go).
        self.avail = snap.node_total.astype(np.int64).copy()
        self.bound_by_node: dict[int, list[int]] = {}
        bound = (self.sched_mask | (snap.job_is_running & ~self.preempt_mask)) & (
            self.assigned >= 0
        )
        for j in np.flatnonzero(bound):
            n = int(self.assigned[j])
            self.avail[n] -= self.req_fit[j]
            self.bound_by_node.setdefault(n, []).append(int(j))
        # Per-queue unweighted current cost (qctx.CurrentCost).
        self.queue_cost = np.zeros(snap.num_queues)
        qreq = snap.job_req.astype(np.float64)
        for q in range(snap.num_queues):
            members = np.flatnonzero(bound & (snap.job_queue == q))
            self.queue_cost[q] = (
                self._cost(qreq[members].sum(axis=0)) if len(members) else 0.0
            )

    def job_cost(self, j: int) -> float:
        return self._cost(self.snap.job_req[j].astype(np.float64))

    def snapshot(self):
        return copy.deepcopy(
            {
                "assigned": self.assigned,
                "avail": self.avail,
                "bound_by_node": self.bound_by_node,
                "queue_cost": self.queue_cost,
            }
        )

    def restore(self, cp):
        self.assigned = cp["assigned"]
        self.avail = cp["avail"]
        self.bound_by_node = cp["bound_by_node"]
        self.queue_cost = cp["queue_cost"]


def _job_size_exceeds(snap, req, limit: dict | None) -> bool:
    if not limit:
        return False
    lim = snap.factory.from_map(limit, ceil=False)
    return bool(np.any((lim > 0) & (req > lim)))


def _victims_for_node(state: _State, n: int, new_prio: int, opt: OptimiserConfig):
    """getPreemptibleJobDetailsByQueue + populateQueueImpactFields +
    globalPreemptionOrder (node_scheduler.go:134-243, preemption_info.go)."""
    snap = state.snap
    by_queue: dict[int, list[dict]] = {}
    for j in state.bound_by_node.get(n, ()):
        if not snap.job_preemptible[j]:
            continue
        g = snap.job_gang[j]
        if (g >= 0 and snap.gang_card[g] > 1) or (
            snap.job_is_running[j] and snap.job_gang_id[j]
        ):
            continue  # don't evict gang jobs (node_scheduler.go:160)
        if _job_size_exceeds(snap, snap.job_req[j], opt.maximum_job_size_to_preempt):
            continue
        sched_at = int(state.sched_prio[j])
        if sched_at > new_prio:
            continue  # can't evict higher-priority work
        q = int(snap.job_queue[j])
        if q < 0:
            continue
        by_queue.setdefault(q, []).append(
            {
                "job": j,
                "queue": q,
                "cost": state.job_cost(j),
                "sched_at": sched_at,
                "id": snap.job_ids[j],
            }
        )
    entries = []
    for q, items in by_queue.items():
        # internalQueueOrder with costToPreempt computed along the sweep
        # (populateQueueImpactFields): cheapest first within the queue.
        items.sort(key=lambda it: (it["sched_at"], it["cost"], it["id"]))
        w = max(state.snap.queue_weight[q], 1e-12)
        cost_now = state.queue_cost[q]
        fairshare = state.fair_share[q]
        for it in items:
            cost_now = _round8(cost_now - it["cost"])
            it["after_w"] = cost_now / w
            if it["sched_at"] < new_prio:
                it["cost_to_preempt"] = 0.0
                it["prio_preemption"] = True
            elif cost_now > fairshare:
                it["cost_to_preempt"] = 0.0
                it["prio_preemption"] = False
            else:
                it["cost_to_preempt"] = it["cost"]
                it["prio_preemption"] = False
        items.sort(
            key=lambda it: (
                it["cost_to_preempt"],
                it["sched_at"],
                it["cost"],
                it["id"],
            )
        )
        for ordinal, it in enumerate(items):
            it["ordinal"] = ordinal
        entries.extend(items)
    entries.sort(
        key=lambda it: (
            not it["prio_preemption"],
            -it["after_w"],
            it["sched_at"],
            it["cost"],
            it["id"],
        )
    )
    return entries


def _try_node(state: _State, j: int, n: int, opt: OptimiserConfig):
    """PreemptingNodeScheduler.Schedule for one (job, node). Returns
    (ok, cost, victims, max_queue_impact)."""
    snap = state.snap
    if not static_feasible(snap, j, n):
        return False, 0.0, [], 0.0
    req = state.req_fit[j]
    avail = state.avail[n].copy()
    if np.all(req <= avail):
        return True, 0.0, [], 0.0
    new_prio = int(snap.job_priority[j])
    victims = _victims_for_node(state, n, new_prio, opt)
    chosen: list[int] = []
    total_cost = 0.0
    qchanges: dict[int, float] = {}
    fits = False
    for it in victims:
        avail = avail + state.req_fit[it["job"]]
        total_cost += it["cost_to_preempt"]
        qchanges[it["queue"]] = qchanges.get(it["queue"], 0.0) - it["cost"]
        chosen.append(it["job"])
        if np.all(req <= avail):
            fits = True
            break
    if not fits:
        return False, 0.0, [], 0.0
    max_impact = 0.0
    for q, change in qchanges.items():
        if state.queue_cost[q] > 0:
            max_impact = max(max_impact, abs(change) / state.queue_cost[q])
    return True, total_cost, chosen, max_impact


def _bind(state: _State, j: int, n: int):
    state.avail[n] -= state.req_fit[j]
    state.bound_by_node.setdefault(n, []).append(j)
    state.queue_cost[int(state.snap.job_queue[j])] += state.job_cost(j)


def _unbind(state: _State, j: int):
    n = int(state.assigned[j])
    state.avail[n] += state.req_fit[j]
    if j in state.bound_by_node.get(n, ()):
        state.bound_by_node[n].remove(j)
    state.queue_cost[int(state.snap.job_queue[j])] -= state.job_cost(j)


def _try_gang(state: _State, members, opt: OptimiserConfig):
    """FairnessOptimisingGangScheduler.Schedule: per member, score every
    node, keep the cheapest that clears the improvement threshold; state
    updates between members so later members see earlier placements
    (gang_scheduler.go:96-146). Returns (ok, {job: node}, [preempted])."""
    snap = state.snap
    cp = state.snapshot()
    placement: dict[int, int] = {}
    all_preempted: list[int] = []
    for j in members:
        j = int(j)
        job_cost = state.job_cost(j)
        best = None
        for n in range(snap.num_nodes):
            ok, cost, victims, impact = _try_node(state, j, n, opt)
            if not ok:
                continue
            if cost > 0:
                improvement = (job_cost / cost) * 100 - 100
                if improvement <= opt.min_fairness_improvement_pct:
                    continue
            key = (cost, impact, int(snap.node_id_rank[n]))
            if best is None or key < best[0]:
                best = (key, n, victims)
            if cost == 0 and not victims:
                break  # ideal result, exit early (gang_scheduler.go:117)
        if best is None:
            state.restore(cp)
            return False, {}, []
        _, n, victims = best
        for v in victims:
            _unbind(state, v)
            all_preempted.append(v)
        placement[j] = n
        _bind(state, j, n)
    state.restore(cp)  # optimise_round re-applies the committed result
    return True, placement, all_preempted


def optimise_round(
    snap: RoundSnapshot, out: dict, opt: OptimiserConfig
) -> list[OptimiserDecision]:
    """OptimisingQueueScheduler.Schedule: repeatedly pick the lowest-cost
    queue whose next unscheduled gang keeps it at/below its fair share and
    place it via the fairness-optimising gang scheduler; stop at the round
    bounds. Mutates `out`'s arrays to include the extra decisions and
    returns them."""
    if not opt.enabled:
        return []
    state = _State(snap, out)
    decisions: list[OptimiserDecision] = []
    total = snap.total_resources.astype(np.float64)
    max_sched = np.full(snap.factory.num_resources, np.inf)
    for name, frac in (opt.maximum_resource_fraction_to_schedule or {}).items():
        i = snap.factory.name_to_index.get(name)
        if i is not None:
            max_sched[i] = frac * total[i]
    scheduled_res = np.zeros(snap.factory.num_resources)
    n_scheduled = 0

    # Per-queue streams of candidate gangs in queue order, capped by the
    # lookback (optimising_queue_scheduler.go uses the same iterators as
    # the main pass).
    streams: dict[int, list] = {}
    for g in np.argsort(snap.gang_order, kind="stable"):
        g = int(g)
        members = snap.gang_members[
            snap.gang_member_offsets[g] : snap.gang_member_offsets[g + 1]
        ]
        q = int(snap.gang_queue[g])
        if not snap.gang_complete[g] or q < 0 or len(members) == 0:
            continue
        if snap.job_is_running[members[0]]:
            continue
        lookback = snap.config.max_queue_lookback
        if lookback and len(streams.get(q, ())) >= lookback:
            continue
        streams.setdefault(q, []).append((g, members))
    heads = {q: 0 for q in streams}
    name_rank = {
        q: int(np.argsort(np.argsort(snap.queue_names))[q]) for q in streams
    }

    while n_scheduled < opt.maximum_jobs_per_round:
        # Candidate PQ: (weighted cost incl gang, queue name rank).
        best = None
        for q, stream in streams.items():
            i = heads[q]
            while i < len(stream) and any(
                state.sched_mask[m] for m in stream[i][1]
            ):
                i += 1
            heads[q] = i
            if i >= len(stream):
                continue
            g, members = stream[i]
            w = max(snap.queue_weight[q], 1e-12)
            gang_req = snap.gang_total_req[g].astype(np.float64)
            cost_incl = state.queue_cost[q] + state._cost(gang_req)
            if cost_incl / w > state.fair_share[q] / w:
                continue  # queue would cross its fair share: skip queue
            key = (cost_incl / w, name_rank[q])
            if best is None or key < best[0]:
                best = (key, q, g, members, gang_req)
        if best is None:
            break
        _, q, g, members, gang_req = best

        skip = False
        if opt.minimum_job_size_to_schedule is not None:
            min_rl = snap.factory.from_map(
                opt.minimum_job_size_to_schedule, ceil=False
            )
            if any(np.any(snap.job_req[m] < min_rl) for m in members):
                skip = True
        if not skip and np.any(scheduled_res + gang_req > max_sched):
            skip = True
        ok = False
        if not skip:
            ok, placement, preempted = _try_gang(state, members, opt)
        if not ok:
            heads[q] += 1  # gang stays unscheduled; move down the stream
            continue

        for v in preempted:
            _unbind(state, v)
            if snap.job_is_running[v]:
                state.preempt_mask[v] = True
            else:
                state.sched_mask[v] = False
            state.assigned[v] = -1
        for j, n in placement.items():
            state.sched_mask[j] = True
            state.assigned[j] = n
            state.sched_prio[j] = snap.job_priority[j]
            _bind(state, j, n)
        scheduled_res += gang_req
        n_scheduled += len(members)
        decisions.append(OptimiserDecision(placement, list(preempted)))
        heads[q] += 1

    out["assigned_node"] = state.assigned
    out["scheduled_mask"] = state.sched_mask
    out["preempted_mask"] = state.preempt_mask
    out["scheduled_priority"] = state.sched_prio
    return decisions
