"""The scheduling round in eager PyTorch: one `solve_round` call runs the
whole preempt-and-schedule round on one device,

  fair shares -> balance eviction -> fairness-order indexing ->
  pass 1 (evicted + queued) -> oversubscription eviction -> pass 2 ->
  finalize,

deciding exactly what the JAX package's fused program decides on the same
padded round (armada_tpu/solver/kernel.py, `solve_impl`).

Where the JAX program runs `lax.while_loop`s and `lax.cond`s on device,
this module runs Python loops and `if`s on scalars read back from the
device, and reads the round's static tables (slot members, counts, run
lengths, queue ranges) from the host copy of the round instead (for a
device-resident round, snapshot/residency.py, its host mirror). Tensors
are never updated in place: a failed gang attempt keeps the carry it
started from, as the functional reference does. The one exception is the
hot window's scatter back into the full carry at a chunk boundary, which
no rollback crosses (solver/hotwindow.py); the carry fields it writes
are the solve's own (cloned or fresh), so the round's tensors, resident
ones included, are only read.

`solve_round` runs the round fused (pass 1 as one segment run to its
end) or through the host-driven driver the scheduler asks for: pass 1 in
chunks of loops under a round budget, with the rescue pass of a
truncated round, optionally over hot windows of the slot and job axes,
with a per-part profile and transfer ledger.

Coverage: every round the reference solves. Every fairness policy
(DRF, proportional, priority, deadline) and market-driven rounds (bid
order, spot price, market eviction); serial gangs plus the single-queue
batched fill or fast fill (the merged multi-queue window fill with its
evicted-rebind window); on one device fused or host-driven (round
budget, hot window, profile), node-sharded fused only, as in the
reference. The policy and the market are static fields of the round, and
each branch on them is a Python branch, so a DRF round runs the ops it
ran before either was ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import HOT_WINDOW_MIN_SLOTS_DEFAULT
from ..core.priorities import EVICTED_PRIORITY, MIN_PRIORITY
from ..device import COST_DTYPE, resolve_device
from ..ops.bitset import as_words, bits_subset
from ..ops.kernels import ScorePlan, pack_plan
from ..ops.segment import segment_sum
from ..observe import ledger
from ..ops.select import lex_argmin, lexsort, masked_lexsort
from .dist import LOCAL, at
from .hotwindow import gather_window, scatter_back, window_lookahead
from .kernel_prep import DeviceRound, _pow2
from .validate import maybe_assert_finite

NO_NODE = -1

# slot_state values
PENDING, DONE, FAILED = 0, 1, 2

# failure codes from a gang attempt
OK, FAIL, FAIL_TERMINAL, FAIL_QUEUE_TERMINAL, FAIL_GANG_PROPERTY = 0, 1, 2, 3, 4

BIG = 2**30
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1



class Carry(NamedTuple):
    alloc: torch.Tensor  # int32[P, N, R]
    qalloc: torch.Tensor  # float64[Q, R]
    qpc_alloc: torch.Tensor  # float64[Q, C, R]
    job_node: torch.Tensor  # int32[J]
    job_prio: torch.Tensor  # int32[J]
    job_evicted: torch.Tensor  # bool[J]
    job_scheduled: torch.Tensor  # bool[J] newly scheduled queued jobs
    slot_state: torch.Tensor  # int8[S]
    evict_rank: torch.Tensor  # int32[J]; -1 inactive, -2 consumed
    tokens: torch.Tensor  # float64 0-d
    qtokens: torch.Tensor  # float64[Q]
    scheduled_new: torch.Tensor  # float64[R]
    floating: torch.Tensor  # float64[R] pool floating-resource allocation
    # Market rounds: the placed gangs' summed request until the spot
    # price is set, and the price (nan until set).
    spot_cost: torch.Tensor  # float64[R]
    spot_price: torch.Tensor  # float64 0-d
    # Host-side loop state: validity flags and the loop counter.
    only_ev_global: bool
    only_ev_queue: np.ndarray  # bool[Q]
    unfeasible: np.ndarray  # bool[G]
    stop: bool
    loops: int


class _Round:
    """One padded round on a device: `h` is the host DeviceRound (numpy,
    read for static per-slot and per-job scalars without a device
    round trip), `t` the same fields as tensors on `device`. Bitset words
    are int32 views of the uint32 host words.

    Under node sharding `dev` is the shard's round: its node-major fields
    (alloc0 on axis 1; node_total, node_taints, node_labels, node_id_rank,
    node_unschedulable and node_gid on axis 0) are the shard's slice, and
    `dist` is bound to the shard (parallel/mesh.py). Every other field is
    whole."""

    def __init__(self, dev: DeviceRound, device: torch.device, dist=LOCAL, *,
                 t: DeviceRound | None = None, base: "_Round | None" = None):
        """`t` and `base` build a hot-window round (solver/hotwindow.py):
        `dev` and `t` are the window's host and device rounds, whose node,
        queue and group fields are the full round's; `base` is the full
        round, whose kernel path, pack plan and loop stats it shares. Its
        score plan is its own, over the window's job rows."""
        self.h = dev
        self.device = device
        if t is None:
            tensors = {}
            for f in dataclasses.fields(dev):
                v = getattr(dev, f.name)
                if isinstance(v, np.ndarray) and v.ndim > 0:
                    if v.dtype == np.uint32:
                        v = as_words(v)
                    tensors[f.name] = torch.as_tensor(
                        np.ascontiguousarray(v), device=device
                    )
            t = dataclasses.replace(dev, **tensors)
        self.t = t
        self.J, self.R = dev.job_req.shape
        self.S, self.M = dev.slot_members.shape
        self.Q = dev.queue_weight.shape[0]
        self.P = dev.priorities.shape[0]
        self.C = dev.pc_priority.shape[0]
        self.G = max(1, int(dev.num_key_groups))
        self.dist = dist
        # Loops by kind (serial gang attempts, single-queue batched fills,
        # merged multi-queue fills) and the host wall seconds spent in
        # each, over the whole solve.
        self.stats = base.stats if base is not None else {
            "gang_loops": 0, "fill_loops": 0, "merged_fill_loops": 0,
            "gang_s": 0.0, "fill_s": 0.0, "merged_fill_s": 0.0,
        }
        self.zero_sel = torch.zeros_like(self.t.uni_value_bits[0])
        self.queue_weight = [float(w) for w in dev.queue_weight]
        self.penalty_f = _f(self.t.queue_short_penalty)
        self.w_clip = torch.clamp(_f(self.t.queue_weight), min=1e-12)
        if base is not None:
            self.kbits, kpath = base.kbits, base.kpath
        else:
            self.kbits = None
            kpath = dev.kernel_path
            if kpath == "cuda":
                # dev holds the shard's nodes: the rank width covers the
                # global node count, local count times shards.
                self.kbits = pack_plan(dev, self.dist.n_shards)
                if self.kbits is None:
                    # The reference's static rule: the fused path engages
                    # only where the key packs into one int64.
                    kpath = "lax"
        if self.kbits is not None:
            # The fused scoring's tables, checked once for the round (the
            # shard's nodes under node sharding, the window's job rows in
            # a window round).
            t = self.t
            self.plan = ScorePlan(
                t.node_total, t.node_taints, t.node_labels, t.node_id_rank,
                t.node_gid, t.node_unschedulable, t.job_tolerated,
                t.job_selector, t.job_req_fit, t.job_excluded_nodes,
                t.job_affinity_group, t.job_possible, t.affinity_allowed,
                t.order_res_idx, t.order_res_resolution,
                torch.tensor(self.kbits, dtype=torch.int32, device=device),
                dev.batch_window,
            )
        self.kpath = kpath
        # The integer scatter-adds run the segment kernel on the "cuda"
        # path and torch's index_add on "lax" (ops/segment.py).
        self.seg_kernel = kpath == "cuda"
        self.knbits = sum(self.kbits) if self.kbits else None

    def up(self, arr, dtype=None):
        """A host array on the round's device."""
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)


def _f(x):
    return x.to(COST_DTYPE)


def _pack_fill_keys(rd, n_local, keys):
    """Fuse the best-fit candidate keys into ONE packed int64 when their
    static bit widths fit, so the fill sort runs one single-key sort
    instead of K+1 stable passes. Order-exact by mixed-radix packing:
    every in-mask key is within [0, 2^bits). Keeps the multi-key list
    when the widths overflow 62 bits."""
    rank_bits = max(1, (n_local * rd.dist.n_shards - 1).bit_length())
    bits = [max(1, int(b)) for b in rd.h.order_key_bits] + [rank_bits]
    if len(bits) != len(keys) or sum(bits) > 62:
        return keys
    acc = torch.zeros(keys[0].shape, dtype=torch.int64, device=keys[0].device)
    for k, b in zip(keys, bits):
        acc = (acc << b) | torch.clamp(k, 0, (1 << b) - 1).to(torch.int64)
    return [acc]


def _drf_cost(alloc, total, mult):
    """DRF cost (fairness.go:103-105); alloc [..., R]."""
    safe = torch.where(total > 0, total, 1.0)
    frac = torch.where(total > 0, alloc / safe, 0.0) * mult
    return torch.clamp(torch.max(frac, dim=-1).values, min=0.0)


def _policy_cost(rd, alloc):
    """The queue-cost measure candidate ordering runs on: DRF's dominant
    resource, or the sum of the resource fractions under proportional
    fairness. The sum runs over the columns in index order, the
    association of the reference's reduction and of the host mirror
    (solver/policy.py), so the keys are bit-equal on any device."""
    t = rd.t
    if rd.h.fairness_policy[0] == "proportional":
        total = t.total_resources
        safe = torch.where(total > 0, total, 1.0)
        frac = torch.where(total > 0, alloc / safe, 0.0) * t.drf_multipliers
        acc = frac[..., 0]
        for r in range(1, frac.shape[-1]):
            acc = acc + frac[..., r]
        return torch.clamp(acc, min=0.0)
    return _drf_cost(alloc, t.total_resources, t.drf_multipliers)


def _fixed_sum(x, dim=-1):
    """The float sum of `x` along `dim` in one fixed order on any device:
    pairwise, adjacent entries first, an odd last entry carried to the
    next level, every level an elementwise add. Elementwise float64 adds
    round the same on the card and the CPU, where `torch.sum` pairs as
    each device's reduction does, so a share summed here has the same
    bits on both (a bundle recorded on the card replays on the CPU)."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        pairs = x[..., 0:n - 1:2] + x[..., 1:n:2]
        x = torch.cat([pairs, x[..., n - 1:]], dim=-1) if n % 2 else pairs
    return x[..., 0]


def _fair_shares(weights, demand_costs, total_is_zero):
    """Water-filling fair shares (context/scheduling.go:252-331): at most
    10 rounds, stopping once less than 0.01 of the pool is unallocated.
    Every sum is `_fixed_sum`."""
    Q = weights.shape[0]
    zeros = torch.zeros(Q, dtype=COST_DTYPE, device=weights.device)
    wsum = _fixed_sum(weights)
    fair_share = torch.where(
        wsum > 0.0, weights / torch.where(wsum > 0.0, wsum, 1.0), 0.0
    )
    demand = torch.where(total_is_zero, 1.0, demand_costs)
    capped, uncapped = zeros, zeros
    achieved = torch.zeros(Q, dtype=torch.bool, device=weights.device)
    spare = zeros
    unallocated = torch.tensor(1.0, dtype=COST_DTYPE, device=weights.device)
    for _ in range(10):
        if not bool(unallocated > 0.01):
            break
        total_weight = _fixed_sum(torch.where(achieved, 0.0, weights))
        total_incl = total_weight + torch.where(achieved, weights, 0.0)
        share = torch.where(
            total_incl > 0,
            weights / torch.where(total_incl > 0, total_incl, 1.0),
            0.0,
        )
        uncapped = uncapped + share * (unallocated - spare)
        live = total_weight > 0.0
        capped = torch.where(
            live & ~achieved,
            capped + (weights / torch.where(live, total_weight, 1.0)) * unallocated,
            capped,
        )
        new_spare = capped - demand
        over = live & (new_spare > 0)
        capped = torch.where(over, demand, capped)
        achieved = achieved | over
        spare = torch.where(over, new_spare, 0.0)
        unallocated = torch.where(
            live, _fixed_sum(torch.where(over, new_spare, 0.0)), 0.0
        )
    return fair_share, capped, uncapped


def _deadline_factors(rd, boost, horizon):
    """The deadline policy's weight boost per queue, elementwise IEEE ops
    only (solver/policy.py `deadline_factors`): queues with no deadline
    keep 1.0. The numerator is a tensor: torch's `scalar / tensor` would
    multiply by the reciprocal and round differently."""
    dl = _f(rd.t.queue_deadline)
    fin = torch.isfinite(dl)
    dmin = torch.min(torch.where(fin, dl, float("inf")))
    rel = torch.clamp(dl - torch.where(torch.any(fin), dmin, 0.0), min=0.0)
    factor = 1.0 + torch.full_like(dl, float(boost)) / (1.0 + rel / float(horizon))
    return torch.where(fin, factor, 1.0)


def _priority_shares(rd, w, demand_costs, total_is_zero):
    """Strict-priority entitlement: queues in descending weight order
    (name rank breaking ties) take their whole demand from what the
    earlier ones left. One float64 accumulator walks the Q queues on the
    host, the reference's IEEE sequence step for step."""
    wsum = _fixed_sum(w)
    fair_share = torch.where(wsum > 0.0, w / torch.where(wsum > 0.0, wsum, 1.0), 0.0)
    demand = torch.where(total_is_zero, 1.0, demand_costs).cpu().numpy()
    w_h = w.cpu().numpy()
    order = np.lexsort((rd.h.queue_name_rank, -w_h))
    capped = np.zeros_like(w_h)
    uncapped = np.zeros_like(w_h)
    cum_prev = np.float64(0.0)
    for qi in order:
        if not w_h[qi] > 0.0:
            continue
        unc = np.minimum(np.maximum(np.float64(1.0) - cum_prev, 0.0), 1.0)
        capped[qi] = np.minimum(demand[qi], unc)
        uncapped[qi] = unc
        cum_prev = cum_prev + demand[qi]
    return fair_share, rd.up(capped), rd.up(uncapped)


def _policy_fair_shares(rd, demand_costs, total_is_zero):
    """Entitlement under the round's policy, the `_fair_shares` seat in
    `_round_setup`. Returns (fair_share, capped, uncapped)."""
    spec = rd.h.fairness_policy
    w = _f(rd.t.queue_weight)
    if spec[0] == "deadline":
        return _fair_shares(w * _deadline_factors(rd, spec[1], spec[2]), demand_costs, total_is_zero)
    if spec[0] == "priority":
        return _priority_shares(rd, w, demand_costs, total_is_zero)
    return _fair_shares(w, demand_costs, total_is_zero)


def _policy_rank_key(rd):
    """The policy's leading candidate and eviction-rank key per queue
    (smaller wins), or None for DRF and proportional, whose key lists
    stay as they were."""
    kind = rd.h.fairness_policy[0]
    if kind == "priority":
        return -_f(rd.t.queue_weight)
    if kind == "deadline":
        return _f(rd.t.queue_deadline)
    return None


def _static_ok(rd, j, extra_sel, extra_tol=None):
    """StaticJobRequirementsMet over all nodes (nodematching.go:161-190)
    for host job index j. extra_sel: additional required label bits (gang
    uniformity value); extra_tol: additional tolerated-taint bits (away
    node types)."""
    t, h = rd.t, rd.h
    tolerated = t.job_tolerated[j]
    if extra_tol is not None:
        tolerated = tolerated | extra_tol
    taints_ok = torch.all((t.node_taints & ~tolerated) == 0, dim=-1)
    sel_ok = bits_subset(t.job_selector[j] | extra_sel, t.node_labels)
    total_ok = torch.all(t.job_req_fit[j] <= t.node_total, dim=-1)
    n_idx = t.node_gid
    excl_ok = torch.all(n_idx[:, None] != t.job_excluded_nodes[j][None, :], dim=-1)
    ok = taints_ok & sel_ok & total_ok & excl_ok & ~t.node_unschedulable
    a = int(h.job_affinity_group[j])
    if a >= 0:
        aff_bits = t.affinity_allowed[min(a, h.affinity_allowed.shape[0] - 1)]
        word = aff_bits[torch.div(n_idx, 32, rounding_mode="floor").to(torch.int64)]
        ok = ok & (((word >> (n_idx % 32)) & 1) != 0)
    if not bool(h.job_possible[j]):
        ok = torch.zeros_like(ok)
    return ok


def _order_keys(rd, alloc_row):
    """Best-fit order keys of one allocation row [N, R]: each order
    resource's allocatable // resolution, then the node id rank."""
    keys = []
    for k in range(rd.h.order_res_idx.shape[0]):
        ri = int(rd.h.order_res_idx[k])
        res = int(rd.h.order_res_resolution[k])
        keys.append(torch.div(alloc_row[:, ri], res, rounding_mode="floor"))
    keys.append(rd.t.node_id_rank)
    return keys


def _row(alloc, row):
    """alloc[row] for a host int or a 0-d index tensor."""
    if isinstance(row, int):
        return alloc[row]
    return at(alloc, row)


def _select_at_row(rd, alloc, j, row, static_ok):
    """First-fit in best-fit order at one priority row (nodedb.go:713-752)."""
    a = _row(alloc, row)
    dyn = torch.all(rd.t.job_req_fit[j] <= a, dim=-1)
    return rd.dist.lex_argmin_nodes(_order_keys(rd, a), static_ok & dyn, rd.t.node_gid)


def fair_preemption_order(c):
    """The (node, -rank) walk order, computed once per pass: ranks are
    fixed at assignment; only the active mask changes as evicted jobs are
    consumed or rescheduled, which the per-select mask handles."""
    rank = c.evict_rank
    return masked_lexsort([c.job_node, BIG - rank], rank >= 0)


def _fair_preemption(rd, c, j, static_ok, fp_order):
    """Vectorized selectNodeForJobWithFairPreemption (nodedb.go:808-899).

    Walk evicted jobs in reverse rank order; node n becomes selectable at the
    first step where its cumulative freed resources cover the job. Choose the
    node whose threshold step is earliest (largest rank)."""
    t, dist = rd.t, rd.dist
    rank = c.evict_rank
    active = rank >= 0
    node = c.job_node
    order = fp_order
    n_sorted = node[order]
    a_sorted = active[order]
    contrib = torch.where(a_sorted[:, None], t.job_req_fit[order], 0).to(torch.int64)
    csum = torch.cumsum(contrib, dim=0)
    pos = torch.arange(node.shape[0], device=node.device)
    is_first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=node.device), n_sorted[1:] != n_sorted[:-1]]
    )
    seg_first = torch.cummax(torch.where(is_first, pos, 0), dim=0).values
    base = csum[seg_first] - contrib[seg_first]
    cwithin = csum - base
    safe_node = torch.clamp(n_sorted, 0, dist.num_nodes(c.alloc) - 1)
    avail = dist.take_rows(c.alloc[0], safe_node).to(torch.int64) + cwithin
    feasible = (
        a_sorted
        & torch.all(avail >= t.job_req_fit[j], dim=-1)
        & dist.take_rows(static_ok, safe_node)
    )
    rank_sorted = rank[order]
    idx, found = lex_argmin([-rank_sorted, pos.to(torch.int32)], feasible)
    sel_node = at(safe_node, idx)
    sel_rank = at(rank_sorted, idx)
    consumed = active & (node == sel_node) & (rank >= sel_rank) & found
    freed = torch.sum(
        torch.where(consumed[:, None], t.job_req_fit, 0), dim=0
    ).to(c.alloc.dtype)
    new_alloc = dist.add_row_at(c.alloc, 0, sel_node, torch.where(found, freed, 0), rd.seg_kernel)
    new_rank = torch.where(consumed, -2, rank)
    preempted_at = torch.max(torch.where(consumed, c.job_prio, MIN_PRIORITY))
    return sel_node, found, preempted_at, new_alloc, new_rank


def _i32(x, device):
    return torch.full((), x, dtype=torch.int32, device=device)


def _select_chain(rd, c, j, prio, extra_sel, extra_tol, fp_order, any_evicted):
    """selectNodeForJobWithTxnAtPriority (nodedb.go:597-662) at one target
    priority (int32 0-d tensor) with optional extra tolerations (away node
    types). Returns (node, found, preempted_at, new_alloc, new_evict_rank)."""
    t = rd.t
    dev = rd.device
    alloc = c.alloc
    row_p = torch.searchsorted(t.priorities, prio.reshape(1)).reshape(())
    static_ok = _static_ok(rd, j, extra_sel, extra_tol)

    n0, f0 = _select_at_row(rd, alloc, j, 0, static_ok)
    _, fp = _select_at_row(rd, alloc, j, row_p, static_ok)

    # Fair preemption involves a J-sized walk; skip it when the evicted-job
    # index is empty (every queued-only round).
    if any_evicted:
        fpre_n, fpre_found, fpre_at, fpre_alloc, fpre_rank = _fair_preemption(
            rd, c, j, static_ok, fp_order
        )
    else:
        fpre_n = _i32(0, dev)
        fpre_found = torch.zeros((), dtype=torch.bool, device=dev)
        fpre_at = _i32(MIN_PRIORITY, dev)
        fpre_alloc, fpre_rank = c.alloc, c.evict_rank

    # Urgency: lowest priority row (ascending) where the job fits.
    urg_n = _i32(0, dev)
    urg_found = torch.zeros((), dtype=torch.bool, device=dev)
    urg_at = _i32(MIN_PRIORITY, dev)
    for r in range(1, rd.P):
        pr = int(rd.h.priorities[r])
        allowed = pr <= prio
        nr, fr = _select_at_row(rd, alloc, j, r, static_ok)
        take = allowed & fr & ~urg_found
        urg_n = torch.where(take, nr, urg_n)
        urg_at = torch.where(take, pr, urg_at)
        urg_found = urg_found | take

    found = f0 | (fp & (fpre_found | urg_found))
    use_fpre = ~f0 & fp & fpre_found
    node = torch.where(f0, n0, torch.where(use_fpre, fpre_n, urg_n))
    preempted_at = torch.where(
        f0, EVICTED_PRIORITY, torch.where(use_fpre, fpre_at, urg_at)
    ).to(torch.int32)
    new_alloc = torch.where(use_fpre, fpre_alloc, c.alloc)
    new_rank = torch.where(use_fpre, fpre_rank, c.evict_rank)
    return node, found, preempted_at, new_alloc, new_rank


def _select_node(rd, c, j, extra_sel, fp_order, pinned, any_evicted):
    """SelectNodeForJobWithTxn (nodedb.go:423-503): pinned reschedule, home
    chain, then away node types at reduced priority. `pinned` is the job's
    evicted flag (host bool). Returns
    (node, found, preempted_at, new_alloc, new_evict_rank, sched_at)."""
    t, h, dist = rd.t, rd.h, rd.dist
    prio = c.job_prio[j]
    if pinned:
        # Pinned (evicted) jobs only ever return to their node: the home
        # chain's result would be discarded, so it is not computed.
        row_p = torch.searchsorted(t.priorities, prio.reshape(1)).reshape(())
        safe_home = torch.clamp(c.job_node[j], 0, dist.num_nodes(c.alloc) - 1)
        home_col = dist.take_col(c.alloc, safe_home)
        over_alloc = torch.any(home_col < 0)
        home_fit = torch.all(t.job_req_fit[j] <= at(home_col, row_p)) | (
            dist.take(t.node_unschedulable, safe_home) & over_alloc
        )
        return safe_home, home_fit, prio, c.alloc, c.evict_rank, prio

    node, found, preempted_at, new_alloc, new_rank = _select_chain(
        rd, c, j, prio, extra_sel, None, fp_order, any_evicted
    )
    sched_at = prio
    pc = int(h.job_pc[j])
    if h.has_away and int(h.pc_away_count[pc]) > 0 and not bool(found):
        # Away node types (nodedb.go:487-501): extra tolerations for the
        # well-known taints, the whole chain at the away priority, bound at
        # that priority so home jobs can urgency-preempt later.
        for a in range(int(h.pc_away_count[pc])):
            a_prio = _i32(int(h.pc_away_prio[pc, a]), rd.device)
            a_node, a_found, a_at, a_alloc, a_rank = _select_chain(
                rd, c, j, a_prio, extra_sel, t.pc_away_tol[pc, a], fp_order,
                any_evicted,
            )
            if bool(a_found):
                return a_node, a_found, a_at, a_alloc, a_rank, a_prio
    return node, found, preempted_at, new_alloc, new_rank, sched_at


def _set(x, i, v):
    """x with x[i] = v (host index or index tensor), as a new tensor."""
    out = x.clone()
    out[i] = v
    return out


def _bind_rows(rd, j, prio):
    """The allocation rows a bind of host job j at priority prio (0-d)
    takes: rows at or below it for a preemptible job, else all."""
    t = rd.t
    if bool(rd.h.job_preemptible[j]):
        return t.priorities <= prio
    return torch.ones_like(t.priorities, dtype=torch.bool)


def _bind(rd, c: Carry, j, n, at_prio, was_evicted) -> Carry:
    """bindJobToNodeInPlace (nodedb.go:911-945) for host job index j on
    node n (0-d) at priority at_prio (0-d); `was_evicted` is the job's
    evicted flag (host bool)."""
    t, h, dist = rd.t, rd.h, rd.dist
    rows = _bind_rows(rd, j, at_prio)
    delta = torch.where(rows[:, None], t.job_req_fit[j], 0).to(c.alloc.dtype)
    alloc = dist.add_col(c.alloc, n, -delta, rd.seg_kernel)
    if was_evicted:
        alloc = dist.add_row_at(alloc, 0, n, t.job_req_fit[j], rd.seg_kernel)
    job_scheduled = c.job_scheduled
    if not was_evicted and not bool(h.job_is_running[j]):
        job_scheduled = _set(job_scheduled, j, True)
    return c._replace(
        alloc=alloc,
        job_node=_set(c.job_node, j, n),
        job_prio=_set(c.job_prio, j, at_prio),
        job_evicted=_set(c.job_evicted, j, False),
        job_scheduled=job_scheduled,
        evict_rank=_set(c.evict_rank, j, -2) if was_evicted else c.evict_rank,
    )


def _constraint_codes(rd, c, slots, all_ev):
    """Round/queue/rate-limit gates (gang_scheduler.go:100-145) for gang
    attempts of the slots `slots` (int64 [K] device tensor of real slots,
    or of anything for entries the caller ignores), on carry c. Returns
    two int32 [K] tensors of OK/FAIL* codes: without the all-evicted
    exemption (the fill gate) and with it for the slots whose members are
    all evicted (`all_ev`, bool [K]: the gang attempt)."""
    t, h = rd.t, rd.h
    q = torch.clamp(t.slot_queue[slots], 0, rd.Q - 1).to(torch.int64)
    pc = t.job_pc[torch.clamp(t.slot_members[slots, 0], 0, rd.J - 1).to(torch.int64)]
    pc = pc.to(torch.int64)
    card = _f(t.slot_count[slots])
    req = _f(t.slot_req[slots])  # [K, R]

    over_round = torch.any(c.scheduled_new > t.max_round_resources)
    no_tokens = c.tokens < 1
    gang_too_big = float(h.global_burst) < card
    tokens_short = c.tokens < card
    qtok = c.qtokens[q]
    qno_tokens = qtok < 1
    qgang_too_big = float(h.queue_burst) < card
    qtokens_short = qtok < card
    # Per-PC cap is would-exceed: the compared allocation includes the
    # candidate gang (gang_scheduler.go:132-140, constraints.go:121-135).
    pc_over = torch.any(c.qpc_alloc[q, pc] + req > t.queue_pc_limit[q, pc], dim=-1)
    cordoned = t.queue_cordoned[q]

    code = torch.where(
        over_round | no_tokens,
        FAIL_TERMINAL,
        torch.where(
            qno_tokens | cordoned,
            FAIL_QUEUE_TERMINAL,
            torch.where(
                gang_too_big,
                FAIL_GANG_PROPERTY,
                torch.where(
                    tokens_short | qgang_too_big | qtokens_short | pc_over,
                    FAIL,
                    OK,
                ),
            ),
        ),
    )
    # Floating-resource pool caps apply to every gang, evicted included,
    # except cross-pool away gangs (context/scheduling.go:546-557).
    floating_over = torch.any(
        t.floating_mask & (c.floating + req > t.floating_total), dim=-1
    ) & ~t.slot_away[slots]
    fill_code = torch.where((code == OK) & floating_over, FAIL, code)
    gang_code = torch.where(all_ev & floating_over, FAIL, torch.where(all_ev, OK, fill_code))
    return fill_code.to(torch.int32), gang_code.to(torch.int32)


def _gang_attempt(rd, c: Carry, s, all_ev, code, fp_order, pinned_h, any_evicted):
    """GangScheduler.Schedule + ScheduleManyWithTxn for host slot s, whose
    constraint code `code` the caller computed on this carry. Returns
    (carry, status code)."""
    t, h = rd.t, rd.h
    q = int(h.slot_queue[s])
    count = int(h.slot_count[s])
    card = float(count)
    pc = int(h.job_pc[h.slot_members[s, 0]])

    def attempt_members(c0, extra_sel):
        """Place the members one by one on carry c0; returns
        (carry, ok, mean preempted-at priority)."""
        cc = c0
        pat_sum = 0.0
        for m in range(count):
            j = int(np.clip(h.slot_members[s, m], 0, rd.J - 1))
            pinned = bool(pinned_h[j])
            node, found, pat, new_alloc, new_rank, sched_at = _select_node(
                rd, cc, j, extra_sel, fp_order, pinned, any_evicted
            )
            found_h, pat_h = torch.stack(
                [found.to(torch.int64), pat.to(torch.int64)]
            ).tolist()
            if not found_h:
                return cc, False, pat_sum / max(card, 1.0)
            cc = cc._replace(alloc=new_alloc, evict_rank=new_rank)
            cc = _bind(rd, cc, j, node, sched_at, pinned)
            pat_sum += float(pat_h)
        return cc, True, pat_sum / max(card, 1.0)

    start_ok = code == OK and int(h.slot_uni_start[s]) >= 0
    ok = False
    attempted = c
    if start_ok:
        uni_start, uni_end = int(h.slot_uni_start[s]), int(h.slot_uni_end[s])
        if uni_end > uni_start:
            # Node-uniformity search (gang_scheduler.go:150-224): evaluate
            # each label value, keep the successful value with the best fit
            # (lowest mean preempted-at priority, first wins ties), then
            # re-attempt and commit that value.
            best_v, best_mean, found_any = 0, float("inf"), False
            for v in range(uni_start, uni_end):
                _, ok_v, mean = attempt_members(c, t.uni_value_bits[v])
                if ok_v and (not found_any or mean < best_mean):
                    best_v, best_mean = v, mean
                found_any = found_any or ok_v
            if found_any:
                attempted, ok, _ = attempt_members(c, t.uni_value_bits[best_v])
        else:
            attempted, ok, _ = attempt_members(c, rd.zero_sel)

    # Commit or roll back.
    new_carry = attempted if ok else c
    slot_state = _set(new_carry.slot_state, s, DONE if ok else FAILED)
    if not ok:
        # Member placement failures are gang-property reasons (JobDoesNotFit
        # / GangDoesNotFit, constraints.go:59-61).
        status = code if code != OK else FAIL_GANG_PROPERTY
        return new_carry._replace(slot_state=slot_state), status

    # Success accounting (AddGangSchedulingContext + rate-limiter reserve).
    req = _f(t.slot_req[s])
    new_carry = new_carry._replace(
        qalloc=_set(new_carry.qalloc, q, new_carry.qalloc[q] + req),
        qpc_alloc=_set(new_carry.qpc_alloc, (q, pc), new_carry.qpc_alloc[q, pc] + req),
        floating=new_carry.floating + torch.where(t.floating_mask, req, 0.0),
        slot_state=slot_state,
    )
    if h.market_driven:
        # Until the spot price is set, every placed gang adds its request;
        # the first whose DRF cost crosses the cutoff sets the price to its
        # own. Device-side, so the loop reads nothing back for it.
        unset = torch.isnan(new_carry.spot_price)
        spot_cost = torch.where(unset, new_carry.spot_cost + req, new_carry.spot_cost)
        crossed = _drf_cost(spot_cost, t.total_resources, t.drf_multipliers) > float(
            h.spot_price_cutoff
        )
        new_carry = new_carry._replace(
            spot_cost=spot_cost,
            spot_price=torch.where(unset & crossed, t.slot_price[s], new_carry.spot_price),
        )
    if not all_ev:
        new_carry = new_carry._replace(
            tokens=new_carry.tokens - card,
            qtokens=_set(new_carry.qtokens, q, new_carry.qtokens[q] - card),
            scheduled_new=new_carry.scheduled_new + req,
        )
    return new_carry, OK


def _slot_valid(rd, c, slots, all_ev_t, include_queued, use_key_skip, flags_t):
    """Validity of the slots `slots` (index tensor) under QueuedGangIterator
    yield semantics: the one predicate behind both the full scan and the
    head-pointer advance."""
    t, h = rd.t, rd.h
    v = (c.slot_state[slots] == PENDING) & (t.slot_count[slots] > 0)
    all_ev = all_ev_t[slots]
    if include_queued:
        only_ev_global, only_ev_queue, unfeasible = flags_t
        only_ev = only_ev_global | only_ev_queue[torch.clamp(t.slot_queue[slots], 0, rd.Q - 1)]
        running = t.slot_is_running[slots]
        active = torch.where(running, all_ev, True)
        v = v & active & (~only_ev | all_ev)
        # Lookback: queued jobs beyond the limit stop yielding; 0 means
        # unlimited (QueuedGangIterator.stopYieldingNewJobsIfLimitHit).
        if h.max_lookback:
            v = v & (running | all_ev | (t.slot_jobs_before[slots] < h.max_lookback))
        if use_key_skip:
            kg = t.slot_key_group[slots]
            v = v & ~((kg >= 0) & unfeasible[torch.clamp(kg, 0, rd.G - 1)])
    else:
        v = v & all_ev
    return v


def _flags_t(rd, c):
    """The carry's validity flags (only-evicted markers, unfeasible keys)
    as device tensors for `_slot_valid`."""
    return (
        torch.tensor(bool(c.only_ev_global), device=rd.device),
        rd.up(c.only_ev_queue),
        rd.up(c.unfeasible),
    )


def _all_evicted(rd, c):
    """Per slot: every member is evicted (stable within a pass)."""
    t = rd.t
    member_mask = torch.arange(rd.M, device=rd.device)[None, :] < t.slot_count[:, None]
    safe = torch.clamp(t.slot_members, 0, rd.J - 1).to(torch.int64)
    return torch.all(torch.where(member_mask, c.job_evicted[safe], True), dim=1)


def _queue_heads(rd, valid):
    """First valid slot per queue, or the queue's end (int32[Q])."""
    t = rd.t
    pos = torch.where(valid, torch.arange(rd.S, dtype=torch.int32, device=rd.device), BIG)
    seg = torch.clamp(t.slot_queue, 0, rd.Q - 1).to(torch.int64)
    heads = torch.full((rd.Q,), BIG, dtype=torch.int32, device=rd.device)
    heads = heads.scatter_reduce(0, seg, pos, reduce="amin", include_self=True)
    return torch.where(heads < BIG, heads, t.queue_slot_end)


def _pass_init_ptrs(rd, c, include_queued, use_key_skip):
    """Initial head pointers for a pass (host int32[Q]): the first valid
    slot per queue, or the queue's end."""
    valid = _slot_valid(
        rd, c, torch.arange(rd.S, device=rd.device), _all_evicted(rd, c),
        include_queued, use_key_skip, _flags_t(rd, c),
    )
    return _queue_heads(rd, valid).cpu().numpy().copy()


def _pass_segment(rd, c: Carry, ptr, force_serial, budgets, loop_cap, *,
                  include_queued, use_key_skip, consider_priority, prefer_large,
                  window_trunc=None):
    """QueueScheduler.Schedule (queue_scheduler.go:91-276) as a host loop:
    one resumable SEGMENT of a pass. Returns (carry, ptr, force_serial).

    Per-queue candidate streams are walked with head pointers (host
    int32[Q], `ptr`): slots are sorted by (queue, segment, order), so each
    queue's next candidate is an advancing index into its slot range. The
    segment continues from the caller's (carry, ptr, force_serial), the
    pass's state, without rescanning; the O(S) full validity scan runs
    only when a validity flag flips (an only-evicted marker or a newly
    registered unfeasible key).

    The segment stops when the pass completes (carry.stop), when
    `carry.loops` reaches `loop_cap`, or after 2*S + 4 loops of its own
    (every loop consumes a slot, flips a flag or arms force-serial). A
    boundary between segments is a loop boundary, where gang attempts are
    complete, so the per-segment recomputation of the all-evicted flags
    and the fair-preemption order is value-identical for every slot still
    PENDING. `rd.stats` accumulates across segments.

    `window_trunc` (bool[Q]) marks a hot-window round
    (solver/hotwindow.py): the queues whose slots are a truncated window
    of the real ones. The segment then also stops, the REWINDOW
    handshake, before any loop in which a truncated queue's in-window
    remainder is shorter than the loop's head lookahead (the fill window,
    or 1 slot in serial mode), so that no loop could have read slots
    beyond the window."""
    t, h = rd.t, rd.h
    Q, S = rd.Q, rd.S
    dev = rd.device
    fill_enabled = (
        h.batch_window > 0
        and include_queued
        and not h.market_driven
        and not consider_priority
    )
    # Fast fill replaces the single-queue fill with the merged step.
    fast_fill_enabled = fill_enabled and bool(h.fast_fill)
    loops0 = c.loops
    lookahead = int(h.batch_window) if fill_enabled else 1
    stats = rd.stats

    # all-evicted flags and the jobs' evicted flags are stable within a
    # pass for every slot still PENDING (evictions happen between passes;
    # a slot's own attempt is the only thing that rebinds its members).
    all_ev_t = _all_evicted(rd, c)
    all_ev_h = all_ev_t.cpu().numpy()
    pinned_h = c.job_evicted.cpu().numpy()
    # Fair-preemption walk order: one sort per segment, not per select.
    fp_order = fair_preemption_order(c)
    any_evicted = bool(torch.any(c.evict_rank >= 0))
    flags_t = _flags_t(rd, c)
    arange_s = torch.arange(S, device=dev)

    # Head pointers, kept on the host (for control flow) and mirrored on
    # the device (for the per-loop key computation) so that no loop pays
    # a host-to-device copy.
    ptr = np.asarray(ptr, dtype=np.int32).copy()
    ptr_t = rd.up(ptr)
    end_h = h.queue_slot_end

    def rescan(cc):
        """Every queue's pointer from the full O(S) validity scan."""
        nonlocal ptr, ptr_t
        valid = _slot_valid(rd, cc, arange_s, all_ev_t, include_queued, use_key_skip, flags_t)
        ptr_t = _queue_heads(rd, valid)
        ptr = ptr_t.cpu().numpy().copy()

    def move(cc, q, p):
        """Set queue q's pointer to its first valid slot at or after p,
        scanning a growing window of slots per device round trip."""
        end = int(end_h[q])
        width = 16
        while p < end:
            hi = min(end, p + width)
            v = _slot_valid(
                rd, cc, torch.arange(p, hi, device=dev), all_ev_t,
                include_queued, use_key_skip, flags_t,
            )
            anyv, first = torch.stack(
                [torch.any(v).to(torch.int64), torch.argmax(v.to(torch.int8))]
            ).tolist()
            if anyv:
                p += first
                break
            p = hi
            width = min(width * 4, 1 << 16)
        ptr[q] = p
        ptr_t[q] = p

    name_rank = t.queue_name_rank
    prk = _policy_rank_key(rd)

    while not c.stop and c.loops < loop_cap and c.loops - loops0 < 2 * S + 4:
        if window_trunc is not None and np.any(window_trunc & ((end_h - ptr) < lookahead)):
            break
        t_loop = time.perf_counter()
        any_head = bool(np.any(ptr < h.queue_slot_end))
        has_head = ptr_t < t.queue_slot_end
        heads = torch.clamp(ptr_t, 0, S - 1).to(torch.int64)

        keys = []
        if h.market_driven:
            # Highest gang price first (market_iterator.go); no cost keys.
            keys.append(-t.slot_price[heads])
        elif consider_priority:
            members = t.slot_members[heads]
            mmask = torch.arange(rd.M, device=dev)[None, :] < t.slot_count[heads][:, None]
            safe = torch.clamp(members, 0, rd.J - 1).to(torch.int64)
            pcp = torch.min(torch.where(mmask, c.job_prio[safe], I32_MAX), dim=1).values
            keys.append(-pcp)
        if not h.market_driven:
            req_h = _f(t.slot_req[heads])  # [Q, R]
            qalloc_cost = c.qalloc + rd.penalty_f
            proposed = _policy_cost(rd, qalloc_cost + req_h) / rd.w_clip
            if prk is not None:
                keys.append(prk)
            if prefer_large:
                current = _policy_cost(rd, qalloc_cost) / rd.w_clip
                size = _policy_cost(rd, req_h) * _f(t.queue_weight)
                over = (proposed > budgets).to(torch.int32)
                keys += [
                    over,
                    torch.where(over == 1, proposed, current),
                    torch.where(over == 1, 0.0, -size),
                ]
            else:
                keys.append(proposed)
        keys.append(name_rank)

        qstar_t, _ = lex_argmin(keys, has_head)
        # The winner's constraint codes, for the fill gate (all-evicted
        # exemption off) and the gang attempt (its own exemption); one
        # device round trip brings them back with the winner.
        all_ev_heads = all_ev_t[heads]
        fill_codes, gang_codes = _constraint_codes(rd, c, heads, all_ev_heads)
        picks = [
            qstar_t.to(torch.int64),
            at(fill_codes, qstar_t).to(torch.int64),
            at(gang_codes, qstar_t).to(torch.int64),
        ]
        if fast_fill_enabled:
            # Evicted heads (all-evicted running singletons) batch through
            # the pinned-rebind window, queued heads through the grouped
            # best-fit window. Their codes exempt evicted heads as the
            # serial path exempts all-evicted gangs (tokens and caps
            # bypassed, floating still gates).
            ev_head = all_ev_heads & _ev_batchable(rd, heads)
            _, merge_codes = _constraint_codes(rd, c, heads, ev_head)
            eligible = (
                has_head
                & (merge_codes == OK)
                & ((t.slot_batchable[heads] & ~all_ev_heads) | ev_head)
            )
            picks.append(torch.any(eligible).to(torch.int64))
        qstar, code_fill, code_gang, *any_eligible = torch.stack(picks).tolist()
        sstar = min(max(int(ptr[qstar]), 0), S - 1)

        do_merge = fast_fill_enabled and bool(any_eligible[0]) and not force_serial
        do_fill = (
            fill_enabled
            and not fast_fill_enabled
            and any_head
            and not force_serial
            and int(h.slot_run_len[sstar]) > 0
            and not bool(all_ev_h[sstar])
            and code_fill == OK
        )
        if do_merge:
            saved_ptr = (ptr.copy(), ptr_t.clone())
            c, progressed, committed = _merged_fill_step(
                rd, c, heads, np.clip(ptr, 0, S - 1), has_head, keys, eligible,
                lambda cc, slots: _slot_valid(
                    rd, cc, slots, all_ev_t, include_queued, use_key_skip, flags_t
                ),
                move, budgets, prefer_large,
            )
            if not committed:
                # The rolled-back step leaves every pointer where it was.
                ptr, ptr_t = saved_ptr
            force_serial = not progressed
            stats["merged_fill_loops"] += 1
            stats["merged_fill_s"] += time.perf_counter() - t_loop
        elif do_fill:
            c, placed = _fill_step(
                rd, c, qstar, sstar, keys, has_head, budgets, prefer_large
            )
            if placed:
                move(c, qstar, sstar + placed)
            force_serial = not placed
            stats["fill_loops"] += 1
            stats["fill_s"] += time.perf_counter() - t_loop
        else:
            flags_before = (
                c.only_ev_global, c.only_ev_queue.copy(), c.unfeasible.copy()
            )
            if any_head:
                c, status = _gang_attempt(
                    rd, c, sstar, bool(all_ev_h[sstar]), code_gang, fp_order,
                    pinned_h, any_evicted,
                )
                # Terminal handling (queue_scheduler.go:176-190).
                sq = int(h.slot_queue[sstar])
                if status == FAIL_TERMINAL and not c.only_ev_global:
                    c = c._replace(only_ev_global=True)
                if status == FAIL_QUEUE_TERMINAL and not c.only_ev_queue[sq]:
                    only_ev_queue = c.only_ev_queue.copy()
                    only_ev_queue[sq] = True
                    c = c._replace(only_ev_queue=only_ev_queue)
                # Register unfeasible keys: single-member, non-evicted slots
                # with gang-property failures (gang_scheduler.go:80-95).
                kg = int(h.slot_key_group[sstar])
                if (
                    status == FAIL_GANG_PROPERTY
                    and int(h.slot_count[sstar]) == 1
                    and kg >= 0
                    and not bool(all_ev_h[sstar])
                ):
                    unfeasible = c.unfeasible.copy()
                    unfeasible[min(kg, c.unfeasible.shape[0] - 1)] = True
                    c = c._replace(unfeasible=unfeasible)
                if any_evicted:
                    any_evicted = bool(torch.any(c.evict_rank >= 0))
            else:
                c = c._replace(stop=True)
            flags_changed = (
                c.only_ev_global != flags_before[0]
                or bool(np.any(c.only_ev_queue != flags_before[1]))
                or bool(np.any(c.unfeasible != flags_before[2]))
            )
            # Consume the winning slot and advance its queue's pointer to the
            # next valid slot; a flag flip can invalidate OTHER queues' heads,
            # so it triggers the full O(S) recompute instead.
            if flags_changed:
                flags_t = _flags_t(rd, c)
                rescan(c)
            elif any_head:
                move(c, qstar, sstar + 1)
            force_serial = False
            stats["gang_loops"] += 1
            stats["gang_s"] += time.perf_counter() - t_loop
        c = c._replace(loops=c.loops + 1)
    return c, ptr, force_serial


def _schedule_pass(rd, c: Carry, budgets, *, include_queued, use_key_skip,
                   consider_priority, prefer_large):
    """One full (unbudgeted) pass: initial pointers, then one segment run
    to completion. The loop counter restarts per pass (the reference's
    loopNumber is per QueueScheduler, queue_scheduler.go:99)."""
    ptr = _pass_init_ptrs(rd, c, include_queued, use_key_skip)
    c = c._replace(stop=False, loops=0)
    c, _, _ = _pass_segment(
        rd, c, ptr, False, budgets, 2 * rd.S + 4, include_queued=include_queued,
        use_key_skip=use_key_skip, consider_priority=consider_priority,
        prefer_large=prefer_large,
    )
    return c


def _f0_chain(rd, alloc0, j):
    """Best-fit candidate-chain inputs for host job j against row-0
    capacity: (fit0 mask, per-node placement caps, node order keys). The
    "cuda" path scores with the fused kernel; "lax" runs the unfused graph."""
    t, h = rd.t, rd.h
    if rd.kbits is not None:
        fit0, caps, key = rd.plan.score(alloc0, j)
        return fit0, caps, [key]
    B = int(h.batch_window)
    req_fit = t.job_req_fit[j]
    static_ok = _static_ok(rd, j, rd.zero_sel)
    fit0 = static_ok & torch.all(req_fit <= alloc0, dim=-1)
    safe_req = torch.clamp(req_fit, min=1)
    caps = torch.min(
        torch.where(
            req_fit[None, :] > 0,
            torch.div(alloc0, safe_req[None, :], rounding_mode="floor"),
            BIG,
        ),
        dim=-1,
    ).values
    caps = torch.clamp(caps, 0, B).to(torch.int32)
    return fit0, caps, _pack_fill_keys(rd, alloc0.shape[0], _order_keys(rd, alloc0))


def _fill_apply(rd, c, qstar, sstar, kmax):
    """Place up to kmax jobs from the identical-singleton run headed at
    sstar onto row-0-feasible nodes in best-fit order (the f0 chain,
    nodedb.go:713-752): a node that wins the best-fit argmin keeps winning
    until the job no longer fits on it, so identical jobs fill nodes to
    capacity in best-fit order. Returns (carry, placed)."""
    t, h, dist = rd.t, rd.h, rd.dist
    B = int(h.batch_window)
    j = int(np.clip(h.slot_members[sstar, 0], 0, rd.J - 1))
    prio = c.job_prio[j]
    pc = int(h.job_pc[j])
    req_fit = t.job_req_fit[j]
    req_full = _f(t.job_req[j])

    fit0, caps, nkeys = _f0_chain(rd, c.alloc[0], j)
    cand_caps, cand_gids = dist.fill_candidates(
        nkeys, fit0, caps, t.node_gid, B, rd.kpath, rd.knbits
    )
    prefix = torch.cumsum(cand_caps, dim=0, dtype=torch.int32)
    total_cap = prefix[-1]
    kstar = int(torch.clamp(
        torch.minimum(kmax, total_cap), 0, min(int(h.slot_run_len[sstar]), B)
    ))
    if kstar == 0:
        return c, 0

    cnt = torch.clamp(kstar - (prefix - cand_caps), min=torch.zeros_like(cand_caps), max=cand_caps)
    delta = dist.segment_to_nodes(
        (cnt[:, None] * req_fit[None, :]).to(c.alloc.dtype), cand_gids, c.alloc.shape[1],
        rd.seg_kernel,
    )
    rows = _bind_rows(rd, j, prio)
    alloc = c.alloc - torch.where(rows[:, None, None], delta[None, :, :], 0)

    ivec = torch.arange(kstar, dtype=torch.int32, device=rd.device)
    pos = torch.searchsorted(prefix, ivec, right=True)
    node_w = cand_gids[torch.clamp(pos, 0, cand_gids.shape[0] - 1)]
    wjobs = t.slot_members[sstar:sstar + kstar, 0].to(torch.int64)
    k_f = float(kstar)
    add = k_f * req_full
    job_node = c.job_node.clone()
    job_node[wjobs] = node_w.to(torch.int32)
    job_prio = c.job_prio.clone()
    job_prio[wjobs] = prio
    job_scheduled = c.job_scheduled.clone()
    job_scheduled[wjobs] = True
    slot_state = c.slot_state.clone()
    slot_state[sstar:sstar + kstar] = DONE
    c2 = c._replace(
        alloc=alloc,
        qalloc=_set(c.qalloc, qstar, c.qalloc[qstar] + add),
        qpc_alloc=_set(c.qpc_alloc, (qstar, pc), c.qpc_alloc[qstar, pc] + add),
        job_node=job_node,
        job_prio=job_prio,
        job_scheduled=job_scheduled,
        slot_state=slot_state,
        tokens=c.tokens - k_f,
        qtokens=_set(c.qtokens, qstar, c.qtokens[qstar] - k_f),
        scheduled_new=c.scheduled_new + add,
        floating=c.floating + torch.where(t.floating_mask, add, 0.0),
    )
    return c2, kstar


def _fill_step(rd, c, qstar, sstar, qkeys, has_head, budgets, prefer_large):
    """Exact single-queue batched fill: stop exactly where the serial loop
    would have switched queues or hit a constraint gate. The queue's PQ
    key after i placements is a closed form of i, so the crossover against
    the (static) runner-up key is computed vectorized; every gate is
    monotone in i, so the stop point is the min of the individual ones.
    Returns (carry, placed); placed == 0 arms force-serial."""
    t, h = rd.t, rd.h
    dev = rd.device
    B = int(h.batch_window)
    j = int(np.clip(h.slot_members[sstar, 0], 0, rd.J - 1))
    pc = int(h.job_pc[j])
    req_full = _f(t.job_req[j])

    # Runner-up queue's key tuple: static during the fill (no other
    # queue's head or allocation changes while this queue wins).
    mask2 = has_head & (torch.arange(rd.Q, device=dev) != qstar)
    q2, found2 = lex_argmin(qkeys, mask2)
    rup = [at(k, q2) for k in qkeys]

    i_f = torch.arange(B, dtype=COST_DTYPE, device=dev)
    qa_i = (c.qalloc[qstar] + rd.penalty_f[qstar])[None, :] + i_f[:, None] * req_full[None, :]
    w_q = max(rd.queue_weight[qstar], 1e-12)
    cur_i = _policy_cost(rd, qa_i) / w_q
    prop_i = _policy_cost(rd, qa_i + req_full[None, :]) / w_q
    my_keys = []
    prk = _policy_rank_key(rd)
    if prk is not None:
        # Constant in i (a fill never moves the policy rank), so the
        # stream stays zip-aligned with the queue pick's keys.
        my_keys.append(prk[qstar].expand(B))
    if prefer_large:
        size = _policy_cost(rd, req_full) * rd.queue_weight[qstar]
        over_i = (prop_i > budgets[qstar]).to(torch.int32)
        my_keys += [
            over_i,
            torch.where(over_i == 1, prop_i, cur_i),
            torch.where(over_i == 1, 0.0, -size),
        ]
    else:
        my_keys.append(prop_i)
    my_keys.append(
        torch.full((B,), int(h.queue_name_rank[qstar]), dtype=torch.int32, device=dev)
    )
    win = torch.zeros(B, dtype=torch.bool, device=dev)
    gt = torch.zeros(B, dtype=torch.bool, device=dev)
    for a, b in zip(my_keys, rup):
        win = win | (~gt & (a < b))
        gt = gt | (a > b)
    win = win | ~found2

    # Constraint gates per step (the serial loop evaluates these before
    # each attempt): i = number already placed.
    tok_ok = (c.tokens - i_f) >= 1
    qtok_ok = (c.qtokens[qstar] - i_f) >= 1
    round_ok = ~torch.any(
        c.scheduled_new[None, :] + i_f[:, None] * req_full[None, :]
        > t.max_round_resources[None, :],
        dim=-1,
    )
    pc_ok = ~torch.any(
        c.qpc_alloc[qstar, pc][None, :] + (i_f + 1.0)[:, None] * req_full[None, :]
        > t.queue_pc_limit[qstar, pc][None, :],
        dim=-1,
    )
    float_ok = ~torch.any(
        t.floating_mask[None, :]
        & (
            c.floating[None, :] + (i_f + 1.0)[:, None] * req_full[None, :]
            > t.floating_total[None, :]
        ),
        dim=-1,
    )
    allowed = win & tok_ok & qtok_ok & round_ok & pc_ok & float_ok
    kmax = torch.sum(torch.cumprod(allowed.to(torch.int32), dim=0)).to(torch.int32)

    return _fill_apply(rd, c, qstar, sstar, kmax)


def _ev_batchable(rd, s):
    """Slots the evicted-rebind window may batch (index tensor s):
    singleton running gangs with no uniformity search, since the pinned
    path consults only the home node. One predicate for head eligibility
    and window membership; callers also require all-evicted (slot
    validity for entries, the all-evicted flags for heads)."""
    t = rd.t
    return (t.slot_count[s] == 1) & t.slot_is_running[s] & (t.slot_uni_end[s] <= t.slot_uni_start[s])


def _total_order(k):
    """A sort key in the total order the reference's sort compares floats
    by (-0.0 below 0.0): a float64 key's bits as int64, the negatives'
    magnitude bits flipped. Integer keys pass through."""
    if not k.dtype.is_floating_point:
        return k
    bits = k.contiguous().view(torch.int64)
    return bits ^ ((bits >> 63) & I64_MAX)


def _int_sum(x, dim):
    """Sum of integer-valued device units, as float64: the int64 sum,
    converted, is the float64 sum bit for bit, whatever the order."""
    return _f(torch.sum(x.to(torch.int64), dim=dim))


def _window_fill_apply(rd, c, q, widx_q, j_q, gid_q, rank_q, kq, pc, j0):
    """Place the accepted window prefix of queue q (kq entries, keys may
    differ). Entries are grouped by interned scheduling key (gid_q, the
    group; rank_q, the entry's rank in it); the groups place in sequence,
    each against row-0 capacity net of the earlier groups, through the
    same best-fit candidate chain as _fill_apply. Placement is cut at the
    first window entry whose group ran out of capacity, so what is
    applied is a stream prefix (the pointer contract). Dead groups are
    skipped from one readback of the group counts. Returns (carry,
    placed); the carry's tensors are new, never `c`'s updated in place."""
    t, h, dist = rd.t, rd.h, rd.dist
    dev = rd.device
    W, G = int(h.batch_window), int(h.fill_groups)
    ln = c.alloc.shape[1]
    ivec = torch.arange(W, dtype=torch.int32, device=dev)
    ent = ivec < kq
    gidc = torch.clamp(gid_q, 0, G - 1).to(torch.int64)
    cnt_g = segment_sum(ent.to(torch.int32), gidc, G, rd.seg_kernel)
    rep = torch.full((G,), BIG, dtype=torch.int32, device=dev).scatter_reduce(
        0, gidc, torch.where(ent, ivec, BIG), reduce="amin", include_self=True
    )
    j_g = torch.clamp(j_q[torch.clamp(rep, 0, W - 1).to(torch.int64)], 0, rd.J - 1)
    cnt_h, j_h = torch.stack([cnt_g.to(torch.int64), j_g.to(torch.int64)]).tolist()
    prio = c.job_prio[j0]

    used = torch.zeros_like(c.alloc[0])
    cand_gids_g = torch.zeros((G, W), dtype=torch.int32, device=dev)
    prefix_g = torch.zeros((G, W), dtype=torch.int32, device=dev)
    placed_g = torch.zeros(G, dtype=torch.int32, device=dev)
    for g in range(G):
        if cnt_h[g] == 0:  # a dead group: no entry has its key
            continue
        j = int(j_h[g])
        req_fit = t.job_req_fit[j]
        fit0, caps, nkeys = _f0_chain(rd, c.alloc[0] - used, j)
        cand_caps, cand_gids = dist.fill_candidates(
            nkeys, fit0, caps, t.node_gid, W, rd.kpath, rd.knbits
        )
        prefix = torch.cumsum(cand_caps, dim=0, dtype=torch.int32)
        placed = torch.clamp(prefix[-1], max=cnt_h[g])
        cnt = torch.clamp(
            placed - (prefix - cand_caps), min=torch.zeros_like(cand_caps), max=cand_caps
        )
        used = used + dist.segment_to_nodes(
            (cnt[:, None] * req_fit[None, :]).to(used.dtype), cand_gids, ln, rd.seg_kernel
        )
        # Fewer than W candidate nodes (small clusters, shard merges): the
        # gids pad with zeros and the prefix with its last value, so the
        # searchsorted below sees a valid sorted row.
        bc = cand_caps.shape[0]
        cand_gids_g[g, :bc] = cand_gids.to(torch.int32)
        prefix_g[g, :bc] = prefix
        if bc < W:
            prefix_g[g, bc:] = prefix[-1]
        placed_g[g] = placed

    ok_e = ent & (rank_q < placed_g[gidc])
    fail_pos = torch.min(torch.where(ent & ~ok_e, ivec, W))
    applied = int(torch.clamp(fail_pos, max=kq))
    if applied == 0:
        return c, 0
    # Entry e's node: the candidate whose prefix first exceeds its rank
    # in its group, searchsorted(side="right") on its group's prefix row.
    pos = torch.searchsorted(prefix_g, rank_q[None, :].expand(G, W).contiguous(), right=True)
    pos = pos.gather(0, gidc[None, :]).squeeze(0)
    node_e = cand_gids_g[gidc, torch.clamp(pos, 0, W - 1)][:applied]
    jobs = j_q[:applied]
    req_fit_e = t.job_req_fit[jobs]
    delta = dist.segment_to_nodes(req_fit_e.to(c.alloc.dtype), node_e, ln, rd.seg_kernel)
    rows = _bind_rows(rd, j0, prio)
    alloc = c.alloc - torch.where(rows[:, None, None], delta[None, :, :], 0)
    sum_full = _int_sum(t.job_req[jobs], 0)
    k_f = float(applied)
    job_node = c.job_node.clone()
    job_node[jobs] = node_e.to(torch.int32)
    job_prio = c.job_prio.clone()
    job_prio[jobs] = prio
    job_scheduled = c.job_scheduled.clone()
    job_scheduled[jobs] = True
    slot_state = c.slot_state.clone()
    slot_state[widx_q[:applied]] = DONE
    c2 = c._replace(
        alloc=alloc,
        qalloc=_set(c.qalloc, q, c.qalloc[q] + sum_full),
        qpc_alloc=_set(c.qpc_alloc, (q, pc), c.qpc_alloc[q, pc] + sum_full),
        job_node=job_node,
        job_prio=job_prio,
        job_scheduled=job_scheduled,
        slot_state=slot_state,
        tokens=c.tokens - k_f,
        qtokens=_set(c.qtokens, q, c.qtokens[q] - k_f),
        scheduled_new=c.scheduled_new + sum_full,
        floating=c.floating + torch.where(t.floating_mask, sum_full, 0.0),
    )
    return c2, applied


def _ev_fill_apply(rd, c, q, widx_q, j_q, kq, pc, j0):
    """Place the accepted window prefix of queue q's evicted singleton
    slots. Pinned semantics (_select_node: an evicted job only returns to
    its node): entry i fits iff its home node still holds its request at
    its priority row, net of the earlier window entries on that node (or
    the over-allocated unschedulable case). The home columns and the
    unschedulable flags come through `dist.take_rows` (one point read each,
    the reference's `take_col` and `take` over the window) and the delta
    goes back through `dist.segment_to_nodes`. Binding mirrors _bind for an
    evicted job: the rows at or below its priority lose the request, row
    0 nets zero; queue accounting grows, tokens and round caps are not
    consumed. Returns (carry, placed); the carry's tensors are new."""
    t, h, dist = rd.t, rd.h, rd.dist
    dev = rd.device
    W, P = int(h.batch_window), rd.P
    ln = c.alloc.shape[1]
    ivec = torch.arange(W, dtype=torch.int32, device=dev)
    ent = ivec < kq
    prio = c.job_prio[j0]
    row_p = torch.searchsorted(t.priorities, prio.reshape(1))
    home = torch.clamp(c.job_node[j_q], 0, dist.num_nodes(c.alloc) - 1)  # [W] global ids
    req_fit = t.job_req_fit[j_q]  # [W, R]

    # What the earlier window entries already placed on each entry's node:
    # an exclusive sum within runs of one home node in (home, entry) order.
    order = torch.sort(home.to(torch.int64) * W + ivec).indices
    contrib = torch.where(ent[:, None], req_fit, 0).to(torch.int64)[order]
    hs = home[order]
    csum = torch.cumsum(contrib, dim=0)
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), hs[1:] != hs[:-1]])
    seg_first = torch.cummax(torch.where(is_first, ivec, 0), dim=0).values.to(torch.int64)
    prior = torch.empty_like(contrib)
    prior[order] = csum - contrib - (csum[seg_first] - contrib[seg_first])

    home_col = dist.take_rows(c.alloc.transpose(0, 1), home)  # [W, P, R]
    # The earlier entries' effect per row: rows at or below the priority,
    # except row 0 (the evicted add-back keeps it flat).
    rows_eff = _bind_rows(rd, j0, prio) & (torch.arange(P, device=dev) > 0)
    col_after = home_col - torch.where(
        rows_eff[None, :, None], prior[:, None, :], 0
    ).to(home_col.dtype)
    fit = torch.all(req_fit <= col_after.index_select(1, row_p).squeeze(1), dim=-1)
    unsched = dist.take_rows(t.node_unschedulable, home)
    over_alloc = torch.any((col_after < 0).reshape(W, -1), dim=1)
    ok_e = ent & (fit | (unsched & over_alloc))
    fail_pos = torch.min(torch.where(ent & ~ok_e, ivec, W))
    applied = int(torch.clamp(fail_pos, max=kq))
    if applied == 0:
        return c, 0
    jobs = j_q[:applied]
    delta = dist.segment_to_nodes(
        req_fit[:applied].to(c.alloc.dtype), home[:applied], ln, rd.seg_kernel
    )
    alloc = c.alloc - torch.where(rows_eff[:, None, None], delta[None], 0)
    sum_full = _int_sum(t.job_req[jobs], 0)
    job_evicted = c.job_evicted.clone()
    job_evicted[jobs] = False
    evict_rank = c.evict_rank.clone()
    evict_rank[jobs] = -2
    slot_state = c.slot_state.clone()
    slot_state[widx_q[:applied]] = DONE
    c2 = c._replace(
        alloc=alloc,
        qalloc=_set(c.qalloc, q, c.qalloc[q] + sum_full),
        qpc_alloc=_set(c.qpc_alloc, (q, pc), c.qpc_alloc[q, pc] + sum_full),
        job_evicted=job_evicted,
        evict_rank=evict_rank,
        slot_state=slot_state,
        floating=c.floating + torch.where(t.floating_mask, sum_full, 0.0),
    )
    return c2, applied


def _merged_fill_step(rd, c, heads, heads_h, has_head, qkeys, eligible, valid, move,
                      budgets, prefer_large):
    """Fast fill: one loop batches the multi-queue sweep over windows of
    consecutive batchable slots, whose scheduling keys may differ.

    Each queue's entry costs follow from the cumulative window requests
    (costs are monotone in the allocation, so each queue's key stream is
    non-decreasing and the serial attempt order across queues is a sort
    of every (queue, entry) key), cut at the best ineligible head's key
    (the barrier: that attempt needs the serial path). Global gates
    (tokens, round caps, floating) cut the merged order at the first
    violation; per-queue gates cut only that queue's entries. Then each
    queue places its entries, in queue order, through the grouped
    best-fit window or, for an evicted head, the pinned-rebind window,
    and its pointer advances (`move`). A capacity shortfall with more
    than one active queue rolls the whole step back: the serial path
    resolves that interleave.

    `heads` are the clamped head slots (device), `heads_h` the same on the
    host; `valid(carry, slots)` is the pass's slot validity. Returns
    (carry, progressed, committed); on a rollback the carry is `c`, which
    no apply updated in place, and the caller restores the pointers."""
    t, h = rd.t, rd.h
    dev = rd.device
    Q, S, J = rd.Q, rd.S, rd.J
    W, G = int(h.batch_window), int(h.fill_groups)
    ivec = torch.arange(W, dtype=torch.int32, device=dev)
    i_f = ivec.to(COST_DTYPE)

    # Per-queue windows: the longest prefix of consecutive in-range,
    # batchable, valid slots sharing the head's priority class. An
    # evicted head's window batches pinned rebinds (singleton evicted
    # slots at one priority); a queued head's the grouped best-fit fill.
    raw = heads[:, None] + ivec[None, :]
    widx = torch.clamp(raw, 0, S - 1)  # [Q, W]
    in_range = raw < t.queue_slot_end[:, None]
    j_w = torch.clamp(t.slot_members[widx, 0], 0, J - 1).to(torch.int64)
    pc_w = t.job_pc[j_w]
    vv = valid(c, widx.reshape(-1)).reshape(Q, W)
    kind_ev = t.slot_is_running[heads]  # [Q]
    prio_w = c.job_prio[j_w]
    kind_ok = torch.where(
        kind_ev[:, None],
        _ev_batchable(rd, widx) & (prio_w == prio_w[:, :1]),
        t.slot_batchable[widx] & ~t.slot_is_running[widx],
    )
    base = eligible[:, None] & in_range & kind_ok & vv & (pc_w == pc_w[:, :1])
    base = torch.cumprod(base.to(torch.int32), dim=1).to(torch.bool)

    # Groups by interned key: gid, the first-appearance rank of an entry's
    # key in its window; rank_in_g, the earlier entries sharing it. Masked
    # entries get unique sentinels. One stable (queue, key, position) sort
    # and a running max of run heads; the window is cut at key G + 1
    # (evicted windows do not group: placement is pinned).
    grp = torch.where(base, t.slot_key_group[widx], -2 - ivec[None, :]).to(torch.int64)
    QW = Q * W
    flat_idx = torch.arange(QW, dtype=torch.int64, device=dev)
    qrow = flat_idx // W
    pos_f = flat_idx % W
    span = int(h.num_key_groups) + W + 3
    order_g = torch.sort(
        (qrow * span + grp.reshape(-1) + W + 2) * W + pos_f, stable=True
    ).indices
    q_s, g_s, p_s = qrow[order_g], grp.reshape(-1)[order_g], pos_f[order_g]
    run_head = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (q_s[1:] != q_s[:-1]) | (g_s[1:] != g_s[:-1]),
    ])
    head_at = torch.cummax(torch.where(run_head, flat_idx, 0), dim=0).values
    rank_in_g = torch.empty(QW, dtype=torch.int32, device=dev)
    rank_in_g[order_g] = (flat_idx - head_at).to(torch.int32)
    rank_in_g = rank_in_g.reshape(Q, W)
    first_j = torch.empty(QW, dtype=torch.int64, device=dev)
    first_j[order_g] = p_s[head_at]
    first_j = first_j.reshape(Q, W)
    first_occ = (first_j == ivec[None, :]) & base
    gnum = torch.cumsum(first_occ.to(torch.int32), dim=1)
    gid = torch.gather(gnum, 1, first_j) - 1
    base = base & ((gid < G) | kind_ev[:, None])
    base = torch.cumprod(base.to(torch.int32), dim=1).to(torch.bool)

    # Entry costs from the cumulative window requests (the serial closed
    # form: entry i's queue allocation is qalloc plus the i earlier window
    # requests).
    req_i = torch.where(base[:, :, None], t.slot_req[widx], 0).to(torch.int64)
    csum_i = torch.cumsum(req_i, dim=1)
    req_e = _f(req_i)
    csum_incl = _f(csum_i)
    csum_prev = _f(csum_i - req_i)
    qa_i = (c.qalloc + rd.penalty_f)[:, None, :] + csum_prev
    w = rd.w_clip[:, None]
    cur = _policy_cost(rd, qa_i) / w
    prop = _policy_cost(rd, qa_i + req_e) / w
    ekeys = []
    prk = _policy_rank_key(rd)
    if prk is not None:
        # Constant per queue: every window stays monotone, and the keys
        # zip with the queue pick's for the barrier compare.
        ekeys.append(prk[:, None].expand(Q, W))
    if prefer_large:
        size = _policy_cost(rd, req_e) * _f(t.queue_weight)[:, None]
        over = (prop > budgets[:, None]).to(torch.int32)
        ekeys += [over, torch.where(over == 1, prop, cur), torch.where(over == 1, 0.0, -size)]
    else:
        ekeys.append(prop)
    ekeys.append(t.queue_name_rank[:, None].expand(Q, W))

    # The merge needs each queue's key stream non-decreasing (only the
    # prefer-large -size tiebreak at tied costs can invert): cut the
    # window at the first inversion.
    dec = torch.zeros((Q, W), dtype=torch.bool, device=dev)
    gtp = torch.zeros((Q, W), dtype=torch.bool, device=dev)
    for k in ekeys:
        prev = torch.cat([k[:, :1], k[:, :-1]], dim=1)
        dec = dec | (~gtp & (k < prev))
        gtp = gtp | (k > prev)
    dec[:, 0] = False
    base = torch.cumprod((base & ~dec).to(torch.int32), dim=1).to(torch.bool)

    # The barrier: the best ineligible head's key; batched entries must be
    # strictly lex-below it (the name rank is unique).
    qb, has_barrier = lex_argmin(qkeys, has_head & ~eligible)
    below = torch.zeros((Q, W), dtype=torch.bool, device=dev)
    gt = torch.zeros((Q, W), dtype=torch.bool, device=dev)
    for a, k in zip(ekeys, qkeys):
        b = at(k, qb)
        below = below | (~gt & (a < b))
        gt = gt | (a > b)
    # Per-queue gates (queue tokens, per-PC caps); evicted windows bypass
    # them, as the serial path's all-evicted exemption does.
    qtok_ok = ((c.qtokens[:, None] - i_f[None, :]) >= 1) | kind_ev[:, None]
    aq = torch.arange(Q, device=dev)
    pc_h = pc_w[:, 0].to(torch.int64)
    pc_ok = ~torch.any(
        c.qpc_alloc[aq, pc_h][:, None, :] + csum_incl > t.queue_pc_limit[aq, pc_h][:, None, :],
        dim=-1,
    ) | kind_ev[:, None]
    entry_ok = base & qtok_ok & pc_ok & (below | ~has_barrier)
    entry_ok = torch.cumprod(entry_ok.to(torch.int32), dim=1).to(torch.bool)

    # The merged order: every entry by key, the position as the last key
    # (equal-cost entries of one queue keep their stream order).
    order = lexsort([_total_order(k.reshape(-1)) for k in ekeys] + [pos_f])
    take = entry_ok.reshape(-1)[order]
    qidx = qrow[order]
    req_s = req_i.reshape(QW, -1)[order]
    # Evicted entries consume neither tokens nor round caps; they count
    # toward floating.
    ev_flat = kind_ev[qidx]
    consuming = take & ~ev_flat
    req_taken = torch.where(take[:, None], req_s, 0)
    req_consumed = torch.where(consuming[:, None], req_s, 0)
    cnt_before = _f(torch.cumsum(consuming.to(torch.int64), dim=0) - consuming.to(torch.int64))
    cum_req = _f(torch.cumsum(req_taken, dim=0))
    cum_req_cb = _f(torch.cumsum(req_consumed, dim=0) - req_consumed)
    tok_ok_g = ((c.tokens - cnt_before) >= 1) | ev_flat
    round_ok_g = ~torch.any(
        c.scheduled_new[None, :] + cum_req_cb > t.max_round_resources[None, :], dim=-1
    ) | ev_flat
    float_ok_g = ~torch.any(
        t.floating_mask[None, :] & (c.floating[None, :] + cum_req > t.floating_total[None, :]),
        dim=-1,
    )
    viol = take & ~(tok_ok_g & round_ok_g & float_ok_g)
    first_viol = torch.where(torch.any(viol), torch.argmax(viol.to(torch.int8)), QW)
    final_take = take & (flat_idx < first_viol)
    k_q = segment_sum(final_take.to(torch.int32), qidx, Q, rd.seg_kernel)

    # Each queue places in turn, against what the earlier queues took.
    k_h, ev_h = torch.stack([k_q.to(torch.int64), kind_ev.to(torch.int64)]).tolist()
    c2, progressed, shortfall = c, False, False
    for q in range(Q):
        kq = int(k_h[q])
        if kq <= 0:
            continue
        j0 = int(np.clip(h.slot_members[heads_h[q], 0], 0, J - 1))
        pc = int(h.job_pc[j0])
        if ev_h[q]:
            c2, placed = _ev_fill_apply(rd, c2, q, widx[q], j_w[q], kq, pc, j0)
        else:
            c2, placed = _window_fill_apply(
                rd, c2, q, widx[q], j_w[q], gid[q], rank_in_g[q], kq, pc, j0
            )
        if placed > 0:
            move(c2, q, int(heads_h[q]) + placed)
        progressed = progressed or placed > 0
        shortfall = shortfall or placed < kq
    # A shortfall with more than one active queue: taken entries did not
    # fit while entries merged after them (other queues) were applied, an
    # interleave the batch cannot express. Roll the step back.
    if shortfall and int(np.count_nonzero(np.asarray(k_h) > 0)) > 1:
        return c, False, False
    return c2, progressed, True


def _apply_evictions(rd, c: Carry, evict_mask):
    """Move evicted jobs' usage to the evicted row and update queue
    accounting (EvictJobsFromNode + sctx.EvictJob)."""
    t, h, dist = rd.t, rd.h, rd.dist
    req_f = _f(t.job_req)
    alloc = c.alloc
    ln = alloc.shape[1]
    rows = []
    for r in range(1, rd.P):
        in_rows = torch.where(t.job_preemptible, int(h.priorities[r]) <= c.job_prio, True)
        contrib = torch.where(
            (evict_mask & in_rows)[:, None], t.job_req_fit, 0
        ).to(alloc.dtype)
        rows.append(alloc[r] + dist.segment_to_nodes(contrib, c.job_node, ln, rd.seg_kernel))
    alloc = torch.stack([alloc[0]] + rows) if rows else alloc

    # Requests are whole device units: their int64 sums, converted, are
    # the float64 sums exactly.
    qseg = torch.clamp(t.job_queue, 0, rd.Q - 1).to(torch.int64)
    sub = torch.where(evict_mask[:, None], t.job_req, 0).to(torch.int64)
    qsub = _f(segment_sum(sub, qseg, rd.Q, rd.seg_kernel))
    pc_seg = qseg * rd.C + t.job_pc.to(torch.int64)
    qpc_sub = _f(segment_sum(sub, pc_seg, rd.Q * rd.C, rd.seg_kernel)).reshape(
        c.qpc_alloc.shape
    )
    floating_sub = torch.sum(
        torch.where(evict_mask[:, None] & t.floating_mask[None, :], req_f, 0.0),
        dim=0,
    )
    return c._replace(
        alloc=alloc,
        qalloc=c.qalloc - qsub,
        qpc_alloc=c.qpc_alloc - qpc_sub,
        floating=c.floating - floating_sub,
        job_evicted=c.job_evicted | evict_mask,
    )


def _assign_evict_ranks(rd, c: Carry, budgets, prefer_large: bool):
    """addEvictedJobsToNodeDb (preempting_queue_scheduler.go:584-633): walk
    evicted slots in candidate order with static allocations, assigning a
    global fairness rank to each member.

    The allocations are static during the walk, so each eligible slot's
    key tuple is fixed: the keys are computed for every eligible slot at
    once on the device, and the walk itself (repeatedly the lex-smallest
    queue head, by the same key comparison as lex_argmin) runs on the host
    over those keys. Rank of step i's member m is i * M + m."""
    t, h = rd.t, rd.h
    M = rd.M
    all_ev = _all_evicted(rd, c)
    eligible = (c.slot_state == PENDING) & all_ev & (t.slot_count > 0)
    slots_h = np.flatnonzero(eligible.cpu().numpy())
    rank = torch.full((rd.J,), -1, dtype=torch.int32, device=rd.device)
    if not len(slots_h):
        return c._replace(evict_rank=rank)

    q_h = h.slot_queue[slots_h].astype(np.int64)
    s_t, q_t = rd.up(slots_h.astype(np.int64)), rd.up(q_h)
    if h.market_driven:
        # Highest gang price first, as the scheduling passes pick.
        cols = [-t.slot_price[s_t]]
    else:
        qalloc_cost = c.qalloc + rd.penalty_f
        req = _f(t.slot_req[s_t])
        w = rd.w_clip[q_t]
        proposed = _policy_cost(rd, qalloc_cost[q_t] + req) / w
        prk = _policy_rank_key(rd)
        # The passes' leading policy key: low-rank queues schedule later,
        # so fair preemption (largest rank first) consumes them first.
        cols = [] if prk is None else [prk[q_t]]
        if prefer_large:
            cur = _policy_cost(rd, qalloc_cost)[q_t] / w
            size = _policy_cost(rd, req) * _f(t.queue_weight)[q_t]
            over = proposed > budgets[q_t]
            cols += [
                over.to(COST_DTYPE),
                torch.where(over, proposed, cur),
                torch.where(over, 0.0, -size),
            ]
        else:
            cols.append(proposed)
    keys = torch.stack(cols, dim=1).cpu().numpy()
    name_rank = h.queue_name_rank

    # Per queue, its eligible slots in slot order (the segment-min head
    # order); each step takes the lex-smallest head key.
    streams = {}
    for i, q in enumerate(q_h.tolist()):
        streams.setdefault(q, []).append(i)
    pos = {q: 0 for q in streams}
    order = []
    while pos:
        best_q, best_key = None, None
        for q, p in pos.items():
            k = tuple(keys[streams[q][p]].tolist()) + (int(name_rank[q]),)
            if best_key is None or k < best_key:
                best_q, best_key = q, k
        order.append(streams[best_q][pos[best_q]])
        pos[best_q] += 1
        if pos[best_q] == len(streams[best_q]):
            del pos[best_q]

    members, values = [], []
    for step, i in enumerate(order):
        s = int(slots_h[i])
        for m in range(int(h.slot_count[s])):
            members.append(int(np.clip(h.slot_members[s, m], 0, rd.J - 1)))
            values.append(step * M + m)
    rank[rd.up(np.asarray(members, dtype=np.int64))] = rd.up(
        np.asarray(values, dtype=np.int32)
    )
    # Larger rank = scheduled later = consumed first by fair preemption,
    # matching ReverseLowerBound.
    return c._replace(evict_rank=rank)


def _oversubscribed_mask(rd, c: Carry):
    """OversubscribedEvictor (eviction.go:133-180)."""
    t, h, dist = rd.t, rd.h, rd.dist
    bound = (c.job_node >= 0) & ~c.job_evicted
    mask = torch.zeros(rd.J, dtype=torch.bool, device=rd.device)
    for r in range(1, rd.P):
        over_nodes = torch.any(c.alloc[r] < 0, dim=-1)
        at_prio = c.job_prio == int(h.priorities[r])
        over_at_job = dist.take_rows(over_nodes, c.job_node)
        mask = mask | (bound & t.job_preemptible & at_prio & over_at_job)
    return mask & (t.job_queue >= 0)


def _gang_complete_mask(rd, c: Carry, evict_mask):
    """Extend an eviction mask to whole gangs (evictGangs)."""
    t = rd.t
    safe = torch.clamp(t.slot_members, 0, rd.J - 1).to(torch.int64)
    member_mask = torch.arange(rd.M, device=rd.device)[None, :] < t.slot_count[:, None]
    slot_has_evicted = torch.any(member_mask & evict_mask[safe], dim=1)
    bound = (c.job_node >= 0) & ~c.job_evicted
    slot_sel = slot_has_evicted & (t.slot_count > 1)
    sel_flat = (slot_sel[:, None] & member_mask).reshape(-1).to(torch.int32)
    hits = segment_sum(sel_flat, safe.reshape(-1), rd.J, rd.seg_kernel)
    return evict_mask | ((hits > 0) & bound)


def _round_setup(rd):
    """Fair shares, initial carry, balance eviction, eviction ranks —
    everything before pass 1. Returns
    (carry, budgets, fair_share, demand_capped, uncapped)."""
    t, h = rd.t, rd.h
    J, Q, S, C, R = rd.J, rd.Q, rd.S, rd.C, rd.R
    dev = rd.device

    # Fair shares from constrained demand.
    demand_capped_pc = torch.minimum(_f(t.queue_demand_pc), t.queue_pc_limit)
    constrained = _fixed_sum(demand_capped_pc, dim=1)  # [Q, R]
    total_is_zero = torch.all(t.total_resources == 0)
    demand_costs = _policy_cost(rd, constrained)
    w = _f(t.queue_weight)
    fair_share, demand_capped, uncapped = _policy_fair_shares(rd, demand_costs, total_is_zero)
    budgets = torch.where(t.queue_weight > 0, demand_capped / w, float("inf"))

    req_f = _f(t.job_req)
    qseg = (
        torch.clamp(t.job_queue, 0, Q - 1).to(torch.int64) * C
        + t.job_pc.to(torch.int64)
    )
    # Whole device units: the int64 sum, converted, is the float64 sum.
    run_alloc = _f(segment_sum(
        torch.where(
            (t.job_is_running & (t.job_queue >= 0))[:, None], t.job_req, 0
        ).to(torch.int64),
        qseg,
        Q * C,
        rd.seg_kernel,
    )).reshape(Q, C, R)
    G = max(1, int(h.num_key_groups))
    c = Carry(
        alloc=t.alloc0.to(torch.int32).clone(),
        qalloc=_f(t.queue_alloc0),
        qpc_alloc=run_alloc,
        job_node=t.job_node.to(torch.int32).clone(),
        job_prio=t.job_prio.to(torch.int32).clone(),
        job_evicted=torch.zeros(J, dtype=torch.bool, device=dev),
        job_scheduled=torch.zeros(J, dtype=torch.bool, device=dev),
        slot_state=torch.zeros(S, dtype=torch.int8, device=dev),
        evict_rank=torch.full((J,), -1, dtype=torch.int32, device=dev),
        tokens=torch.tensor(float(h.global_tokens), dtype=COST_DTYPE, device=dev),
        qtokens=_f(t.queue_tokens),
        scheduled_new=torch.zeros(R, dtype=COST_DTYPE, device=dev),
        floating=torch.sum(
            torch.where(
                (t.job_is_running & (t.job_node >= 0))[:, None]
                & t.floating_mask[None, :],
                req_f,
                0.0,
            ),
            dim=0,
        ),
        spot_cost=torch.zeros(R, dtype=COST_DTYPE, device=dev),
        spot_price=torch.tensor(float("nan"), dtype=COST_DTYPE, device=dev),
        only_ev_global=False,
        only_ev_queue=np.zeros(Q, dtype=bool),
        unfeasible=np.zeros(G, dtype=bool),
        stop=False,
        loops=0,
    )

    # 1. Balance eviction (NodeEvictor + gang completion).
    actual_cost = _policy_cost(rd, c.qalloc)
    fs = torch.maximum(demand_capped, fair_share)
    fraction = torch.where(fs > 0, actual_cost / fs, float("inf"))
    evict_queue = fraction > float(h.protected_fraction)
    qidx = torch.clamp(t.job_queue, 0, Q - 1).to(torch.int64)
    if h.market_driven:
        # Market rounds evict everything bound, preemptible or not; the
        # price order decides who returns.
        evict0 = t.job_is_running & (t.job_queue >= 0) & (c.job_node >= 0)
    else:
        evict0 = (
            t.job_is_running
            & t.job_preemptible
            & (t.job_queue >= 0)
            & (c.job_node >= 0)
            & evict_queue[qidx]
        )
    evict0 = _gang_complete_mask(rd, c, evict0)
    c = _apply_evictions(rd, c, evict0)
    c = _assign_evict_ranks(rd, c, budgets, bool(h.prefer_large))
    return c, budgets, fair_share, demand_capped, uncapped


def _round_finish(rd, c, budgets, fair_share, demand_capped, uncapped):
    """Oversubscription eviction, pass 2 and finalization into the result
    dict (device tensors)."""
    t = rd.t
    # 3. Oversubscription eviction.
    over = _oversubscribed_mask(rd, c)
    over = _gang_complete_mask(rd, c, over)
    # Back out per-round scheduled resources for re-evicted new jobs.
    sched_backout = torch.sum(
        torch.where((over & c.job_scheduled)[:, None], _f(t.job_req), 0.0), dim=0
    )
    c = _apply_evictions(rd, c, over)
    c = c._replace(scheduled_new=c.scheduled_new - sched_backout)
    # Re-open ONLY slots whose members were just oversubscription-evicted.
    member_mask = torch.arange(rd.M, device=rd.device)[None, :] < t.slot_count[:, None]
    safe = torch.clamp(t.slot_members, 0, rd.J - 1).to(torch.int64)
    slot_all_over = torch.all(
        torch.where(member_mask, over[safe], True), dim=1
    ) & (t.slot_count > 0)
    c = c._replace(
        slot_state=torch.where(slot_all_over, PENDING, c.slot_state).to(torch.int8),
        only_ev_global=False,
        only_ev_queue=np.zeros(rd.Q, dtype=bool),
    )
    if bool(torch.any(over)):
        c = _assign_evict_ranks(rd, c, budgets, bool(rd.h.prefer_large))
        # 4. Pass 2: evicted only, considering priority-class priority.
        c = _schedule_pass(
            rd, c, budgets, include_queued=False, use_key_skip=False,
            consider_priority=True, prefer_large=bool(rd.h.prefer_large),
        )

    # 5. Finalize.
    preempted = t.job_is_running & c.job_evicted
    scheduled = c.job_scheduled & ~c.job_evicted
    assigned = torch.where(c.job_evicted, NO_NODE, c.job_node).to(torch.int32)
    return {
        "assigned_node": assigned,
        "scheduled_priority": c.job_prio,
        "scheduled_mask": scheduled,
        "preempted_mask": preempted,
        "fair_share": fair_share,
        "demand_capped_fair_share": demand_capped,
        "uncapped_fair_share": uncapped,
        "num_loops": np.asarray(c.loops, dtype=np.int32),
        "spot_price": c.spot_price,
    }


def solve_impl(rd: _Round):
    c, budgets, fair_share, demand_capped, uncapped = _round_setup(rd)
    # 2. Pass 1: evicted + queued.
    c = _schedule_pass(
        rd, c, budgets, include_queued=True, use_key_skip=True,
        consider_priority=False, prefer_large=bool(rd.h.prefer_large),
    )
    return _round_finish(rd, c, budgets, fair_share, demand_capped, uncapped)


# ---------------------------------------------------------------------------
# The host-driven driver (the JAX package's budget-aware, segmented and
# hot-window driver): pass 1 runs as a sequence of SEGMENTS with a
# wall-clock check between them. The decision stream is identical to the
# fused solve's (segment boundaries are loop boundaries), so a truncated
# round's QUEUED placements are a prefix of the full round's; evicted
# running jobs get their pinned rebind attempt in the finish's rescue
# pass, so truncation also never preempts a running job the full round
# would have kept (truncated preemptions are a subset of the full
# round's).
# ---------------------------------------------------------------------------


def _pass1_begin(rd):
    """Everything before pass 1, and pass 1's initial pointers."""
    c, budgets, fair_share, demand_capped, uncapped = _round_setup(rd)
    ptr = _pass_init_ptrs(rd, c, True, True)
    c = c._replace(stop=False, loops=0)
    return c, ptr, budgets, fair_share, demand_capped, uncapped


def _pass1_segment(rd, c, ptr, fs, budgets, loop_cap, window_trunc=None):
    """One pass-1 segment: of the full round, or of a hot-window round
    with the rewindow stop for its truncated queues."""
    return _pass_segment(
        rd, c, ptr, fs, budgets, loop_cap, include_queued=True, use_key_skip=True,
        consider_priority=False, prefer_large=bool(rd.h.prefer_large),
        window_trunc=window_trunc,
    )


def _normalize_window_ptrs(rd, c, ptr):
    """Advance each pass-1 pointer to its queue's next valid slot at or
    after it, in one full O(S) scan (host int32[Q]).

    The pointer invariant is "ptr rests on a valid slot or the queue
    end"; a window segment can break it when the in-window advance is cut
    at the window edge. Validity only falls within a pass (flags only
    set, consumption only forward), so completing the skip here, against
    the same carry, lands where the full round's advance would have; a
    pointer already on a valid slot stays. Run before every gather, so a
    window never opens on an invalid head and a queue whose remaining
    stream is all invalid jumps straight to its end."""
    t = rd.t
    valid = _slot_valid(
        rd, c, torch.arange(rd.S, device=rd.device), _all_evicted(rd, c), True, True,
        _flags_t(rd, c),
    )
    pos = torch.arange(rd.S, dtype=torch.int32, device=rd.device)
    seg = torch.clamp(t.slot_queue, 0, rd.Q - 1).to(torch.int64)
    ahead = valid & (pos >= rd.up(ptr)[seg])
    heads = torch.full((rd.Q,), BIG, dtype=torch.int32, device=rd.device).scatter_reduce(
        0, seg, torch.where(ahead, pos, BIG), reduce="amin", include_self=True
    )
    return torch.where(heads < BIG, heads, t.queue_slot_end).cpu().numpy().astype(np.int32)


def _finish(rd, c, budgets, fair_share, demand_capped, uncapped, rescue: bool):
    """Steps 3-5 after a host-driven pass 1, with the rescue pass of a
    truncated round first. Pass 1 evicts running jobs up front, so
    stopping it early would finalize evicted but never attempted jobs as
    PREEMPTED. An evicted-only pass gives every still-pending evicted slot
    its pinned rebind attempt (an evicted job only returns to its own
    node). Rebind capacity at the truncation point is a superset of what
    the full round's later attempts would see, so truncated preemptions
    are a subset of the full round's. Only truncated rounds run it: after
    a complete pass 1 no evicted slot is pending, and an untruncated
    host-driven round stays loop for loop the fused solve."""
    if rescue:
        loops0 = c.loops
        c = _schedule_pass(
            rd, c, budgets, include_queued=False, use_key_skip=False,
            consider_priority=False, prefer_large=bool(rd.h.prefer_large),
        )
        c = c._replace(loops=loops0 + c.loops)
    return _round_finish(rd, c, budgets, fair_share, demand_capped, uncapped)


def _window_precheck(dev: DeviceRound, window, min_slots):
    """Static hot-window sizing (Ws, lookahead), or None when compaction
    cannot pay off.

    Ws is the per-queue window in slots: the configured size rounded up
    to the pass's head lookahead and bucketed to a power of two.
    Compaction engages only when the slot axis clears `min_slots` and the
    window axes are strictly smaller than the full ones: the slot side
    below half, the job side merely below the full axis (M is the widest
    gang, so Q*Ws*M overestimates the members of a singleton-dominated
    window). Needs no device data, so the choice between the fused and the
    host-driven solve is made before anything runs."""
    if not window or int(window) <= 0:
        return None
    Q = int(dev.queue_weight.shape[0])
    S, M = (int(x) for x in dev.slot_members.shape)
    J = int(dev.job_req.shape[0])
    if S < int(min_slots):
        return None
    la = window_lookahead(dev)
    Ws = _pow2(max(int(window), la), 1)
    if 2 * Q * Ws >= S or Q * Ws * M + 1 >= J:
        return None
    return Ws, la


def _window_plan(rd, c, pre):
    """Finish the window plan against the live carry: Ep is the padded
    room for out-of-window evicted jobs, bucketed from the round's evicted
    count (one readback a round; the set only shrinks during pass 1, so
    the bucket holds all pass long). A huge evicted set can still veto
    compaction here: the job axis would not shrink."""
    if pre is None:
        return None
    Ws, la = pre
    n_evicted = int(torch.sum(c.evict_rank >= 0))
    Ep = _pow2(max(n_evicted, 1), 1)
    if rd.Q * Ws * rd.M + Ep >= rd.J:
        return None
    return Ws, Ep, la


def _adapt_chunk(budget_s, t0, executed):
    """The next chunk's loops: re-check the clock roughly every budget/8,
    never batching more than one loop when a single loop exceeds that
    interval (the burst regime), so the overshoot stays one fill loop."""
    target = max(float(budget_s) / 8.0, 0.02)
    per_loop = (time.monotonic() - t0) / executed
    return max(1, min(int(target / max(per_loop, 1e-7)), 4096))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_slice(dev: DeviceRound) -> None:
    """Raise ValueError for a round no path of the port solves: one whose
    kernel path is neither "lax" nor "cuda"."""
    if dev.kernel_path not in ("lax", "cuda"):
        raise ValueError(f"kernel_path must be 'lax' or 'cuda', not {dev.kernel_path!r}")


def _torch_dtype(arr: np.ndarray) -> torch.dtype:
    """The dtype `_Round` gives a host array on the device (uint32 bitsets
    travel as their int32 words)."""
    return torch.from_numpy(np.empty(0, np.int32 if arr.dtype == np.uint32 else arr.dtype)).dtype


def _split_round(dev: DeviceRound, host: DeviceRound | None, device: torch.device):
    """(h, t) for `_Round`: the host round the solve reads its static
    tables from, and the round's tensors on `device` (None when `dev` is a
    host round, which `_Round` uploads).

    A round whose array leaves are tensors (a device-resident round,
    snapshot/residency.py) needs `host`, the numpy mirror of those
    tensors (`ResidentRound.host_round()`): the host side reads the mirror
    and nothing is read back from the device. The static fields and the
    scalars come from `dev`, whose kernel path a caller may have
    replaced."""
    if not any(isinstance(getattr(dev, f.name), torch.Tensor) for f in dataclasses.fields(dev)):
        if host is not None:
            raise ValueError("solve_round: host= is the mirror of a round of tensors; "
                             "this round holds numpy arrays")
        return dev, None
    if host is None:
        raise ValueError("solve_round: a round of tensors needs its host mirror "
                         "(host=ResidentRound.host_round())")
    mirror = {}
    for f in dataclasses.fields(dev):
        v = getattr(dev, f.name)
        if isinstance(v, np.ndarray) and v.ndim > 0:
            raise ValueError(f"solve_round: {f.name} is a numpy array in a round of tensors")
        if not isinstance(v, torch.Tensor):
            continue
        if not ledger.same_device(v.device, device):
            raise ValueError(f"solve_round: {f.name} is on {v.device}, the solve on {device}")
        h = getattr(host, f.name)
        if not (isinstance(h, np.ndarray) and tuple(h.shape) == tuple(v.shape)
                and _torch_dtype(h) == v.dtype):
            raise ValueError(f"solve_round: the host mirror's {f.name} does not match the tensor")
        mirror[f.name] = h
    return dataclasses.replace(dev, **mirror), dev


# Round readback trim (solve_round(readback_rows=...)): the per-job
# decision arrays whose padded tail is inert by construction — pad rows
# are impossible jobs bound nowhere (kernel_prep.pad_device_round).
_JOB_READBACK = {
    "assigned_node": NO_NODE,
    "scheduled_priority": 0,
    "scheduled_mask": False,
    "preempted_mask": False,
}
_READBACK_CHUNK = 16384
_readback_buckets: dict = {}


def _readback_bucket(padded_j: int, rows: int) -> int:
    need = min(padded_j, -(-max(int(rows), 1) // _READBACK_CHUNK) * _READBACK_CHUNK)
    cur = _readback_buckets.get(padded_j, 0)
    if need > cur:
        _readback_buckets[padded_j] = need
        cur = need
    return cur


def _numpy(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _materialize_out(out, dev, readback_rows):
    """Device outputs -> numpy, reading back only the unpadded prefix of
    the per-job decision arrays when the caller gave the live row count.
    Returns (numpy dict, for the transfer ledger, and re-expand callable):
    the ledger books the trimmed readback, then the caller re-expands to
    the padded length with the inert pad fills, so every consumer sees
    padded-shape arrays, byte-identical to a full readback."""
    padded_j = int(dev.job_req.shape[0])
    if readback_rows is None or int(readback_rows) >= padded_j:
        return {k: _numpy(v) for k, v in out.items()}, lambda o: o
    bucket = _readback_bucket(padded_j, readback_rows)
    np_out = {}
    for k, v in out.items():
        if k in _JOB_READBACK and tuple(v.shape[:1]) == (padded_j,):
            v = v[:bucket]
        np_out[k] = _numpy(v)

    def expand(o):
        for k, fill in _JOB_READBACK.items():
            arr = o.get(k)
            if arr is not None and arr.shape[:1] == (bucket,):
                o[k] = np.pad(arr, (0, padded_j - bucket), constant_values=fill)
        return o

    return np_out, expand


def solve_round(
    dev: DeviceRound,
    *,
    budget_s: float | None = None,
    chunk_loops: int = 1,
    window: int | None = None,
    window_min_slots: int = HOT_WINDOW_MIN_SLOTS_DEFAULT,
    profile: bool = False,
    readback_rows: int | None = None,
    device=None,
    stats: dict | None = None,
    host: DeviceRound | None = None,
):
    """Run the round solve on `device` (the CUDA card by default); returns
    the same dict of numpy arrays under the same keys as the JAX package's
    `solve_round`, plus a `truncated` flag when budgeted and a `profile`
    dict on the host-driven paths. `dev` is a padded host DeviceRound, or
    a device-resident one (snapshot/residency.py) whose array leaves are
    tensors on `device`, with `host` its numpy mirror
    (`ResidentRound.host_round()`); see `_split_round`. A resident round
    books no upload, and the solve never writes into its tensors.

    budget_s=None (the default) runs pass 1 to completion. With a budget,
    pass 1 runs in chunks of loops with the wall clock checked between
    chunks; once the budget is spent the pass stops starting loops, the
    rescue pass, the oversubscription repair, pass 2 and the finalization
    still run, and the caller gets `truncated=True`. The chunk starts at
    `chunk_loops` loops and adapts upward only while a loop takes far less
    than the budget. A budget spent before the first loop still runs one
    chunk (the forward-progress floor), so budget_s=1e-6 runs exactly
    `chunk_loops` loops of pass 1.

    window=W turns on hot-window compaction (solver/hotwindow.py): pass 1
    runs over a gathered active set of about W slots per queue, with the
    results scattered back at chunk boundaries and a re-gather (REWINDOW)
    whenever a queue's window runs low, bit-exact with the uncompacted
    round. It engages only where the window axes shrink the round and
    the slot axis clears `window_min_slots` (`_window_precheck`); other
    rounds solve as without a window.

    profile=True takes the host-driven driver even without a budget or a
    window. Every host-driven run attaches out["profile"]: wall seconds
    per part (setup, pass 1, gather and scatter, finish), pass-1 loop
    counts by kind, whether it compacted, the window's slots, the
    rewindows, and the solve's transfer ledger (observe/ledger.py).

    readback_rows (the unpadded live-job count) trims the device->host
    readback of the per-job decision arrays to that prefix; the padded
    tail is inert and re-expanded on the host. `stats`, when given, is
    filled with the loop counts by kind and the host seconds in each,
    over the whole solve (both passes)."""
    check_slice(dev)
    device = resolve_device(device)
    h, t = _split_round(dev, host, device)
    use_budget = bool(budget_s) and budget_s > 0
    pre = _window_precheck(h, window, window_min_slots)
    if not use_budget and pre is None and not profile:
        # The fused solve, with no `truncated` or `profile` key. The
        # ledger books the round's upload (none for a resident round) and
        # the outputs' readback into whatever ledger the caller activated.
        ledger.note_up(dev, site="solve.dispatch", device=device)
        return solve_shard(dev, device, LOCAL, readback_rows=readback_rows, stats=stats,
                           host=host)

    with ledger.round_ledger() as led:
        deadline = time.monotonic() + float(budget_s) if use_budget else None
        # One upload: every chunk and window reads the round's tensors.
        ledger.note_up(dev, site="solve.h2d", device=device)
        rd = _Round(h, device, t=t)
        t0 = time.monotonic()
        c, ptr, budgets, fair_share, demand_capped, uncapped = _pass1_begin(rd)
        setup_s = time.monotonic() - t0
        fs = False
        hard_cap = 2 * rd.S + 4
        chunk = max(1, int(chunk_loops))
        truncated = False
        plan = _window_plan(rd, c, pre)
        rewindows = 0
        gather_s = 0.0
        t_pass = time.monotonic()

        if plan is None:
            while True:
                loops = c.loops
                if c.stop or loops >= hard_cap:
                    break
                # Forward-progress floor: a budget spent before the first
                # loop still runs one chunk, so a persistently tiny budget
                # drains the backlog instead of starving it.
                if deadline is not None and loops > 0 and time.monotonic() >= deadline:
                    truncated = True
                    break
                cap = hard_cap if deadline is None else min(loops + chunk, hard_cap)
                t0 = time.monotonic()
                c, ptr, fs = _pass1_segment(rd, c, ptr, fs, budgets, cap)
                if deadline is not None:
                    chunk = _adapt_chunk(budget_s, t0, max(1, c.loops - loops))
        else:
            Ws, Ep, lookahead = plan
            qbase = np.arange(rd.Q) * Ws
            done = False
            while not done:
                t0 = time.monotonic()
                ptr = _normalize_window_ptrs(rd, c, ptr)
                win_base = ptr
                h_w, t_w, c_w, ptr_w, trunc, win_len, sidx, jidx = gather_window(
                    rd.h, rd.t, c, ptr, Ws, Ep
                )
                rd_w = _Round(h_w, device, t=t_w, base=rd)
                end_w = qbase + win_len
                gather_s += time.monotonic() - t0
                while True:
                    loops = c_w.loops
                    rewind = not c_w.stop and bool(np.any(trunc & ((end_w - ptr_w) < lookahead)))
                    if c_w.stop or loops >= hard_cap:
                        done = True
                        break
                    if rewind:
                        break
                    if deadline is not None and loops > 0 and time.monotonic() >= deadline:
                        truncated = True
                        done = True
                        break
                    cap = hard_cap if deadline is None else min(loops + chunk, hard_cap)
                    t0 = time.monotonic()
                    c_w, ptr_w, fs = _pass1_segment(
                        rd_w, c_w, ptr_w, fs, budgets, cap, window_trunc=trunc
                    )
                    if deadline is not None:
                        chunk = _adapt_chunk(budget_s, t0, max(1, c_w.loops - loops))
                t0 = time.monotonic()
                # The scatter updates the full carry's job and slot rows in
                # place.
                ledger.note_donated(
                    (c.job_node, c.job_prio, c.job_evicted, c.job_scheduled,
                     c.evict_rank, c.slot_state),
                    site="scatter_back",
                )
                c, ptr = scatter_back(c, c_w, ptr_w, sidx, jidx, win_base, Ws)
                del rd_w, c_w
                gather_s += time.monotonic() - t0
                if not done:
                    rewindows += 1

        _sync(device)
        pass1_s = time.monotonic() - t_pass - gather_s
        pass1_stats = dict(rd.stats)
        t0 = time.monotonic()
        out = _finish(rd, c, budgets, fair_share, demand_capped, uncapped, truncated)
        _sync(device)
        finish_s = time.monotonic() - t0
        out, expand = _materialize_out(out, h, readback_rows)
        ledger.note_down(out, site="solve.d2h")
        out = expand(out)
        if stats is not None:
            stats.update(rd.stats)
        maybe_assert_finite(out, "armada_tpu_torch.solve_round[host-driven]")
        if use_budget:
            out["truncated"] = truncated
        out["profile"] = {
            "setup_s": round(setup_s, 4),
            "pass1_s": round(pass1_s, 4),
            "gather_s": round(gather_s, 4),
            "finish_s": round(finish_s, 4),
            "gang_loops": int(pass1_stats["gang_loops"]),
            "fill_loops": int(pass1_stats["fill_loops"]),
            "merged_fill_loops": int(pass1_stats["merged_fill_loops"]),
            "compacted": plan is not None,
            "window_slots": int(plan[0]) if plan else 0,
            "rewindows": rewindows,
            "transfer": led.as_dict(),
        }
        return out


def solve_shard(dev: DeviceRound, device: torch.device, dist, *,
                readback_rows: int | None = None, stats: dict | None = None,
                host: DeviceRound | None = None):
    """The fused round on `device` through `dist`: the whole round with
    LOCAL, or one shard's round (its slice of the node-major fields) with a
    dist bound to that shard, on the shard's thread (parallel/mesh.py).
    Returns the decision dict of numpy arrays; see `solve_round` (and
    `_split_round` for `host`)."""
    h, t = _split_round(dev, host, device)
    rd = _Round(h, device, dist, t=t)
    out, expand = _materialize_out(solve_impl(rd), h, readback_rows)
    ledger.note_down(out, site="solve.d2h")
    out = expand(out)
    if stats is not None:
        stats.update(rd.stats)
    maybe_assert_finite(out, "armada_tpu_torch.solve_round")
    return out
