"""The plain reference of one scheduling round, in NumPy and Python.

It decides which queued jobs a round leases, from the pool's state at the
round's start: each queue's running allocation, its queued jobs in order,
the rate limiter's tokens. It follows Armada's queue scheduler
(internal/scheduler/scheduling/queue_scheduler.go and gang_scheduler.go):
the queue whose head gang has the lowest proposed dominant-resource cost
goes next, ties by queue name; a gang needs a global and a queue token
for each member, and the first job that finds no global token ends the
round; a queue stops after `max_queue_lookback` queued jobs looked at.

It also places them, as the configuration's fast fill states
(`enable_fast_fill`: node assignment greedy per queue rather than
attempt-interleaved; `fill_group_max`: a queue's window grouped by
scheduling key): queue by queue in name order, each queue's leases
grouped by request in order of first appearance, and each job of a
group on the best-fit node, Armada's node selection (nodedb.go:713-752):
of the nodes it fits, the one whose free resources, each rounded down to
its indexed resolution in the indexed order (cpu at 100m, then memory
at 100Mi), are lexicographically smallest, ties by node id. The
reference holds itself to a domain and says so where a round leaves
it: a queue above its protected share (balance eviction would run), or
too little free room for every job it leases to fit wherever the
program puts it (then a batch could come up short and the program
would resolve the round serially, interleaved across queues).

Written without the program: it imports nothing of `armada_tpu_torch`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Round:
    """One round's inputs, as plain arrays. Resources are two lanes,
    cpu millicores and memory bytes."""

    queue_names: list
    weight: np.ndarray  # float64[Q]
    alloc: np.ndarray  # int64[Q, 2], running jobs' requests
    total: np.ndarray  # int64[2], the pool's capacity
    streams: list  # per queue: int64 job indices, in scheduling order
    job_req: np.ndarray  # int64[J, 2]
    gang_lead: np.ndarray  # int64[J]: the gang's key (the job itself if single)
    gang_card: np.ndarray  # int64[J]
    global_tokens: float
    queue_tokens: np.ndarray  # float64[Q]
    global_burst: int
    queue_burst: int
    lookback: int
    order: str = "drf"  # "fifo" is the control: queue fairness ignored


def drf_cost(alloc, total) -> float:
    """Armada's dominant-resource cost: the largest share of any resource
    (fairness.go; a resource with no capacity counts 0)."""
    best = 0.0
    for a, t in zip(alloc, total):
        if t > 0:
            best = max(best, float(a) / float(t))
    return best


class _Stream:
    """One queue's candidate gangs (QueuedGangIterator): members gather
    under their gang's key until the gang's cardinality is met."""

    def __init__(self, jobs, rd: Round):
        self.jobs, self.rd = jobs, rd
        self.pos, self.seen = 0, 0
        self.acc: dict = {}

    def next(self):
        rd = self.rd
        while self.pos < len(self.jobs):
            if self.seen >= rd.lookback:
                return None
            j = int(self.jobs[self.pos])
            self.pos += 1
            self.seen += 1
            card = int(rd.gang_card[j])
            if card <= 1:
                return [j]
            members = self.acc.setdefault(int(rd.gang_lead[j]), [])
            members.append(j)
            if len(members) >= card:
                del self.acc[int(rd.gang_lead[j])]
                return members
        return None


def plan_round(rd: Round) -> list[int]:
    """The round's leases: job indices in lease order."""
    Q = len(rd.queue_names)
    alloc = rd.alloc.astype(np.int64).copy()
    gtok = float(min(rd.global_tokens, rd.global_burst))
    qtok = np.minimum(rd.queue_tokens.astype(np.float64), float(rd.queue_burst))
    streams = [_Stream(s, rd) for s in rd.streams]
    heads = [st.next() for st in streams]
    done = [False] * Q
    leased: list[int] = []

    def key(q):
        members = heads[q]
        if rd.order == "fifo":
            return (min(members), rd.queue_names[q])
        req = rd.job_req[members].sum(axis=0)
        return (drf_cost(alloc[q] + req, rd.total) / rd.weight[q], rd.queue_names[q])

    keys = [key(q) if heads[q] is not None else None for q in range(Q)]
    while True:
        best = None
        for q in range(Q):
            if done[q] or heads[q] is None:
                continue
            if best is None or keys[q] < keys[best]:
                best = q
        if best is None:
            break
        q, members = best, heads[best]
        card = len(members)
        ok = False
        if gtok < 1:
            break  # the global rate limit ends the round
        if card > rd.global_burst or gtok < card:
            pass  # the gang fails; the round goes on
        elif qtok[q] < 1:
            done[q] = True
        elif card > rd.queue_burst or qtok[q] < card:
            pass
        else:
            ok = True
        if ok:
            gtok -= card
            qtok[q] -= card
            alloc[q] += rd.job_req[members].sum(axis=0)
            leased.extend(members)
        if not done[q]:
            heads[q] = streams[q].next()
            keys[q] = key(q) if heads[q] is not None else None
    return leased


def outside_domain(rd: Round, protected_fraction: float, node_free: np.ndarray,
                   n_leased: int, largest: np.ndarray) -> str | None:
    """Why the reference cannot decide this round, or None.

    - A queue whose cost exceeds `protected_fraction` of its weight's
      share would have its preemptible jobs evicted first (the evictor
      compares against the larger of the demand-capped and the weighted
      share, so under this bound it evicts nothing).
    - Each lease takes at most one "largest job" slot from one node
      (`node_free // largest`, the least over the lanes), so with as
      many slots as leases every leased job fits wherever the earlier
      ones went."""
    share = rd.weight / rd.weight.sum()
    for q in range(len(rd.queue_names)):
        if drf_cost(rd.alloc[q], rd.total) > protected_fraction * share[q]:
            return f"queue {rd.queue_names[q]} above its protected share"
    slots = int(np.min(node_free // largest[None, :], axis=1).clip(min=0).sum())
    if slots < n_leased:
        return f"{slots} free slots for the largest job, {n_leased} leases"
    return None


# Armada's indexedResources (config.yaml): the node order's lanes and
# resolutions, cpu millicores then memory bytes.
RESOLUTION = np.array([100, 100 << 20], dtype=np.int64)


def place_round(rd: Round, leased: list, node_free: np.ndarray, node_rank: np.ndarray,
                queue_of: np.ndarray) -> dict:
    """{job: node index} for the round's leases (plan_round's order),
    placed as the module docstring says. `node_free` int64[N, 2] is the
    free room at the round's start, `node_rank` the rank of each node's
    id, `queue_of` each job's queue index. A job that fits nowhere gets
    -1. A node that wins keeps winning for identical jobs until they no
    longer fit, since each placement lowers its key, so a group fills
    the fitting nodes in key order, each to as many jobs as it holds."""
    free = node_free.astype(np.int64).copy()
    by_queue: dict = {}
    for j in leased:
        by_queue.setdefault(int(queue_of[j]), []).append(int(j))
    node_of: dict = {}
    for q in sorted(by_queue, key=lambda q: rd.queue_names[q]):
        groups: dict = {}
        for j in by_queue[q]:
            groups.setdefault(tuple(rd.job_req[j].tolist()), []).append(j)
        for req, jobs in groups.items():
            req = np.asarray(req, dtype=np.int64)
            fits = np.flatnonzero(np.all(free >= req, axis=1))
            key = free[fits] // RESOLUTION
            order = fits[np.lexsort((node_rank[fits], key[:, 1], key[:, 0]))]
            safe = np.where(req > 0, req, 1)
            caps = np.min(np.where(req > 0, free[order] // safe, np.iinfo(np.int64).max), axis=1)
            i = 0
            for n, cap in zip(order.tolist(), caps.tolist()):
                take = min(int(cap), len(jobs) - i)
                for j in jobs[i:i + take]:
                    node_of[j] = n
                free[n] -= take * req
                i += take
                if i == len(jobs):
                    break
            for j in jobs[i:]:
                node_of[j] = -1
    return node_of
