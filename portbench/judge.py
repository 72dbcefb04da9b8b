"""Whether what the timed path produced is correct.

After the window, every cycle the run made (the cold cycle, the warm-up
and the window) is held to the plain reference. The pool's state at a
round's start is worked out from the benchmark's own inputs (what it
submitted, each job's runtime, the nodes) and from the leases the
program published in the cycles before: a job leased in cycle c with a
runtime of p periods is started by its executor's tick in cycle c + 1
and reported done by the tick of cycle c + 1 + p, so it is running in
rounds c + 1 .. c + p. So the reference follows the program round by
round from the program's own history; the cold cycle, which has none,
is checked from the inputs alone.

Numbers compared, each with its limit (all exact, limit 0):
- lease_mismatches: jobs in one of the program's and the reference's
  lease sets of a round and not in the other, a job leased twice, or a
  lease at another priority than its class's;
- preemption_mismatches: preemptions (the reference expects none in its
  domain);
- misplaced_leases: leases on a node the pool does not have, or of
  another executor than the node's;
- placement_mismatches: leases the reference makes too, on another node
  than the reference's best-fit placement (reference.place_round);
- overcommitted_nodes: a node's running and newly leased jobs above its
  capacity, counted once a round;
- completion_mismatches: jobs reported done in another cycle than their
  runtime gives, or never;
- rounds_outside_reference: rounds the reference cannot decide
  (reference.outside_domain);
- truncated_rounds: rounds after the cold one that the round budget
  (`max_scheduling_duration_s`) cut short. The cold cycle builds the
  whole backlog's snapshot inside the budget, so at a large backlog the
  budget may cut its round: the program states that a cut round commits
  a prefix of the full round's decisions, so there its leases are judged
  as a subset of the reference's, each on the reference's node.

`control` puts a variant of the reference in the program's place: its
rounds are judged instead of the program's, from the same state.
"fifo" breaks queue fairness (candidates in submission order across
queues), "firstfit" breaks best fit (each job on the first node by
index that it fits).
"""

from __future__ import annotations

import numpy as np

from .reference import Round, outside_domain, place_round, plan_round
from .traffic import cpu_millis, mem_bytes

LIMITS = {
    "lease_mismatches": 0,
    "preemption_mismatches": 0,
    "misplaced_leases": 0,
    "placement_mismatches": 0,
    "overcommitted_nodes": 0,
    "completion_mismatches": 0,
    "rounds_outside_reference": 0,
    "truncated_rounds": 0,
}
CONTROLS = ("fifo", "firstfit")


def _jobs(traffic, n_cycles):
    """Every job submitted in cycles 0 .. n_cycles - 1, as arrays indexed
    by sequence number."""
    blocks = [traffic.block(k) for k in range(n_cycles)]
    cat = lambda f: np.concatenate([getattr(b, f) for b in blocks])  # noqa: E731
    mem = int(traffic.mix["memory_gi_per_cpu"]) << 30
    cpu = cat("cpu")
    return {
        "submit": np.concatenate([np.full(b.n, b.cycle, dtype=np.int64) for b in blocks]),
        "queue": cat("queue"),
        "req": np.stack([cpu * 1000, cpu * mem], axis=1).astype(np.int64),
        "runtime": cat("runtime"),
        "gang_lead": cat("gang_lead"),
        "gang_card": cat("gang_card"),
    }


def judge(traffic, nodes, cycles, priority, control: str | None = None) -> dict:
    """{"checks": {name: {"value", "limit"}}, "bad_cycles": [cycle
    numbers with any fault], "notes": [first few faults, in words]}.

    `nodes` is [(node id, executor, cpu quantity, memory quantity)];
    `cycles` the run's records in cycle order from 0, each with
    `leases` [(job id, executor, node id, priority)], `preempted` [job
    ids], `succeeded` [job ids reported done by that cycle's ticks] and
    `truncated` (the budget cut the round);
    `priority` the leased jobs' class priority."""
    cfg = traffic.config
    K = len(cycles)
    jobs = _jobs(traffic, K)
    J = len(jobs["submit"])
    Q = len(traffic.queues)
    node_index = {n[0]: i for i, n in enumerate(nodes)}
    node_exec = [n[1] for n in nodes]
    node_cap = np.array([[cpu_millis(n[2]), mem_bytes(n[3])] for n in nodes], dtype=np.int64)
    node_rank = np.argsort(np.argsort([n[0] for n in nodes], kind="stable"), kind="stable")
    total = node_cap.sum(axis=0)
    largest = jobs["req"].max(axis=0)
    weight = np.full(Q, 1.0 / max(float(cfg["queue_priority_factor"]), 1e-9))
    seq_of = lambda job_id: int(job_id.rsplit("-", 1)[1])  # noqa: E731

    lease_cycle = np.full(J, np.iinfo(np.int64).max, dtype=np.int64)
    lease_node = np.full(J, -1, dtype=np.int64)
    checks = dict.fromkeys(LIMITS, 0)
    bad: set[int] = set()
    notes: list[str] = []

    def fault(k, name, n, what):
        if n:
            checks[name] += n
            bad.add(k)
            if len(notes) < 8:
                notes.append(f"cycle {k}: {what}")

    period = float(cfg["schedule_period_s"])
    gburst = int(cfg["maximum_scheduling_burst"])
    qburst = int(cfg["maximum_per_queue_scheduling_burst"])
    gtok, qtok = float(gburst), np.full(Q, float(qburst))
    end = lease_cycle + 0
    for k, rec in enumerate(cycles):
        # Tokens: the service's buckets refill by rate x period between
        # cycles, capped at the burst (none before the first).
        if k:
            gtok = min(gtok + period * float(cfg["maximum_scheduling_rate"]), float(gburst))
            qtok = np.minimum(qtok + period * float(cfg["maximum_per_queue_scheduling_rate"]),
                              float(qburst))
        # Completions reported by this cycle's ticks.
        due = np.flatnonzero(end == k)
        got = {seq_of(j) for j in rec["succeeded"]}
        fault(k, "completion_mismatches", len(got.symmetric_difference(due.tolist())),
              f"{len(got)} jobs reported done, {len(due)} due")

        submitted = jobs["submit"] <= k
        running = (lease_cycle < k) & (end > k)
        queued = submitted & (lease_cycle >= k)
        run_idx = np.flatnonzero(running)
        alloc = np.zeros((Q, 2), dtype=np.int64)
        np.add.at(alloc, jobs["queue"][run_idx], jobs["req"][run_idx])
        used = np.zeros_like(node_cap)
        np.add.at(used, lease_node[run_idx], jobs["req"][run_idx])
        q_idx = np.flatnonzero(queued)
        order = np.argsort(jobs["queue"][q_idx], kind="stable")
        split = np.searchsorted(jobs["queue"][q_idx][order], np.arange(Q + 1))
        streams = [q_idx[order[split[q]:split[q + 1]]] for q in range(Q)]
        rd = Round(
            queue_names=list(traffic.queues), weight=weight, alloc=alloc, total=total,
            streams=streams, job_req=jobs["req"], gang_lead=jobs["gang_lead"],
            gang_card=jobs["gang_card"], global_tokens=gtok, queue_tokens=qtok,
            global_burst=gburst, queue_burst=qburst, lookback=int(cfg["max_queue_lookback"]),
        )
        want = plan_round(rd)
        where = place_round(rd, want, node_cap - used, node_rank, jobs["queue"])
        why = outside_domain(rd, float(cfg["protected_fraction_of_fair_share"]),
                             node_cap - used, len(want), largest)
        fault(k, "rounds_outside_reference", int(why is not None), f"outside the reference: {why}")

        cut = bool(rec.get("truncated", False))
        if control is not None:
            leases, preempted, cut = _control(control, rd, want, node_cap - used, node_rank,
                                              jobs, traffic, nodes, priority), [], False
        else:
            leases, preempted = rec["leases"], rec["preempted"]
        fault(k, "truncated_rounds", int(cut and k > 0), "the round budget cut a warm round")

        fault(k, "preemption_mismatches", len(preempted), f"{len(preempted)} preemptions")
        got_seq = []
        for job_id, executor, node_id, prio in leases:
            s = seq_of(job_id)
            n = node_index.get(node_id, -1)
            if s >= J or jobs["submit"][s] > k or lease_cycle[s] < k:
                fault(k, "lease_mismatches", 1, f"{job_id} not queued")
                continue
            if prio != priority:
                fault(k, "lease_mismatches", 1, f"{job_id} leased at priority {prio}")
            if n < 0 or node_exec[n] != executor:
                fault(k, "misplaced_leases", 1, f"{job_id} on {node_id} of {executor}")
            got_seq.append(s)
            lease_cycle[s], lease_node[s] = k, max(n, 0)
        got_set = set(got_seq)
        if len(got_set) != len(got_seq):
            fault(k, "lease_mismatches", len(got_seq) - len(got_set), "a job leased twice")
        diff = (got_set - set(want)) if cut else got_set.symmetric_difference(want)
        fault(k, "lease_mismatches", len(diff),
              f"{len(got_set)} leased, {len(want)} by the reference, {len(diff)} apart")
        moved = [s for s in got_set if s in where and lease_node[s] != where[s]]
        fault(k, "placement_mismatches", len(moved),
              f"{len(moved)} leases on another node than the reference's best fit")
        new = np.fromiter(got_set, dtype=np.int64, count=len(got_set))
        end[new] = k + 1 + jobs["runtime"][new]
        gtok = max(0.0, gtok - len(new))
        qtok = np.maximum(0.0, qtok - np.bincount(jobs["queue"][new], minlength=Q))
        np.add.at(used, lease_node[new], jobs["req"][new])
        over = int(np.any(used > node_cap, axis=1).sum())
        fault(k, "overcommitted_nodes", over, f"{over} nodes over capacity")
    # Jobs due after the last cycle are not judged; the last cycle's
    # completions were.
    return {
        "checks": {name: {"value": int(v), "limit": LIMITS[name]} for name, v in checks.items()},
        "bad_cycles": sorted(bad),
        "notes": notes,
    }


def _control(name, rd, want, free, node_rank, jobs, traffic, nodes, priority) -> list:
    """The round's leases as the control `name` makes them."""
    if name == "fifo":
        rd.order = "fifo"
        fifo = plan_round(rd)
        rd.order = "drf"
        at = place_round(rd, fifo, free, node_rank, jobs["queue"]) if fifo else {}
        placed = [(j, at[j]) for j in fifo]
    elif name == "firstfit":
        free = free.copy()
        placed = []
        for j in want:
            n = int(np.argmax(np.all(free >= jobs["req"][j], axis=1)))
            free[n] -= jobs["req"][j]
            placed.append((j, n))
    else:
        raise ValueError(f"no control {name!r}")
    return [(traffic.job_id(j), nodes[n][1], nodes[n][0], priority) for j, n in placed]
