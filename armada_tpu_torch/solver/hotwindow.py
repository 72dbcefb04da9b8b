"""Hot-window compaction for the pass-1 solve.

`gather_window` compacts, per queue, the next `Ws` slots at the current
head pointer, plus the members of those slots and every still-active
evicted job (the fair-preemption candidate set), into a dense window
round whose job and slot axes are O(Q*Ws) instead of O(J) and O(S). The
unchanged pass-1 machinery (`kernel._pass_segment`: serial gang
attempts, batched fill, merged fill) then runs over the window axes, and
`scatter_back` writes the window rows into the full carry at chunk
boundaries.

Bit-exactness against the uncompacted round, by construction (as in the
JAX package's hot window):

  - The pass reads a bounded lookahead past a queue's head: 1 slot in
    serial mode, `batch_window` slots in the fill modes. A window segment
    stops (the REWINDOW handshake) as soon as any truncated queue's
    in-window remainder drops below that lookahead, so every executed
    loop sees exactly the slots the full round would.
  - Evicted jobs are candidates for fair preemption wherever their slot
    sits, so ALL evict_rank >= 0 jobs ride along (deduplicated against
    window-slot members through `job_slot`); the walk's selection is
    keyed by unique ranks, so the extra inert rows cannot change it.
  - Everything else the pass touches is either queue-, node- or
    group-axis state shared whole with the full round (qalloc, alloc,
    the uniformity and affinity tables) or gathered slot and job rows
    whose values are those of the full tables. Dead window rows (index
    -1) take fill values that no predicate admits: impossible jobs bound
    nowhere, count-0 slots of no queue.

A round lives twice in the port (`kernel._Round`): the host DeviceRound
`h` (numpy), read for static control flow, and the same fields as device
tensors `t`. The window gathers both from the same indices: `t` on the
device from the full round's tensors (no re-upload), `h` with numpy. The
slot indices follow from the host pointers; the evicted job indices take
one readback per gather.

`scatter_back` updates the full carry's job and slot tensors IN PLACE,
unlike the rest of the solver, which never updates a tensor in place (a
failed gang attempt keeps the carry it started from). It is safe here
because the window segments work on gathered copies and no rollback
crosses a chunk boundary: nothing holds the full carry's tensors but the
driver, which replaces its carry with the returned one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NO_NODE = -1

# Fill values making a dead (index -1) window row inert for every
# predicate of the pass: impossible jobs bound nowhere, count-0 slots of
# no queue.
_JOB_FILLS = {
    "job_req": 0,
    "job_req_fit": 0,
    "job_tolerated": 0,
    "job_selector": 0,
    "job_possible": False,
    "job_queue": -1,
    "job_prio": 0,
    "job_preemptible": False,
    "job_is_running": False,
    "job_node": NO_NODE,
    "job_key_group": -1,
    "job_pc": 0,
    "job_excluded_nodes": -1,
    "job_affinity_group": -1,
    "job_slot": -1,
    "job_bid": 0.0,
}
_SLOT_FILLS = {
    "slot_count": 0,
    "slot_queue": -1,
    "slot_is_running": False,
    "slot_req": 0,
    "slot_key_group": -1,
    "slot_jobs_before": 0,
    "slot_run_len": 0,
    "slot_batchable": False,
    "slot_uni_start": 0,
    "slot_uni_end": 0,
    "slot_price": 0.0,
    "slot_away": False,
}


def _rows(arr, idx, fill):
    """arr[idx] with the idx == -1 rows set to `fill` (any leading axis),
    for a numpy array with a numpy index or a tensor with a tensor index."""
    if isinstance(arr, torch.Tensor):
        idx = idx.to(torch.int64)
        v = arr.index_select(0, torch.clamp(idx, 0, arr.shape[0] - 1))
        ok = (idx >= 0).reshape(idx.shape + (1,) * (v.ndim - 1))
        return torch.where(ok, v, torch.tensor(fill, dtype=v.dtype, device=v.device))
    v = np.take(arr, np.clip(idx, 0, arr.shape[0] - 1), axis=0)
    ok = (idx >= 0).reshape(idx.shape + (1,) * (v.ndim - 1))
    return np.where(ok, v, np.asarray(fill, v.dtype))


def window_lookahead(dev) -> int:
    """Slots the pass-1 loop may read ahead of a queue's head pointer:
    the fill window in the batched modes, one slot in serial mode."""
    if dev.batch_window > 0 and not dev.market_driven:
        return int(dev.batch_window)
    return 1


def _window_fields(dev, sidx, jidx, members_w, starts, ends):
    """The window round's replaced fields of `dev` (numpy or tensors)."""
    return dataclasses.replace(
        dev,
        slot_members=members_w,
        queue_slot_start=starts,
        queue_slot_end=ends,
        **{n: _rows(getattr(dev, n), sidx, f) for n, f in _SLOT_FILLS.items()},
        **{n: _rows(getattr(dev, n), jidx, f) for n, f in _JOB_FILLS.items()},
    )


def gather_window(h, t, carry, ptr, Ws: int, Ep: int):
    """Compact the live frontier into dense window rounds.

    `h` is the full host DeviceRound (numpy), `t` the same round's tensors
    on the device, `carry` the full kernel.Carry and `ptr` the host head
    pointers (int32[Q]). Returns
    (h_w, t_w, carry_w, ptr_w, trunc, win_len, sidx, jidx):
      h_w / t_w - the window round on the host and on the device (slot
      axis Q*Ws, job axis Q*Ws*M + Ep; queue, node and group axes shared
      with the full round, the device's node tables the same tensors);
      carry_w - the window carry (job and slot rows gathered, the rest
      shared); ptr_w - window-local head pointers; trunc[q] - queue q has
      real slots beyond its window; win_len - each queue's window length;
      sidx / jidx - the gather indices (-1: dead row), for scatter_back.
    Every returned index array is on the host (numpy int32)."""
    ptr = np.asarray(ptr, dtype=np.int32)
    Q = int(h.queue_slot_end.shape[0])
    M = int(h.slot_members.shape[1])
    dev = t.slot_members.device
    qvec = np.arange(Q, dtype=np.int32)
    ivec = np.arange(Ws, dtype=np.int32)

    end = h.queue_slot_end.astype(np.int32)
    win_len = np.clip(end - ptr, 0, Ws).astype(np.int32)
    trunc = (ptr + Ws) < end
    sidx = np.where(ivec[None, :] < win_len[:, None], ptr[:, None] + ivec[None, :], -1)
    sidx = sidx.reshape(-1).astype(np.int32)

    # Window job axis: the members of every window slot (position-mapped:
    # window slot s member m is row s*M + m), then the out-of-window
    # active evicted jobs, in index order, padded to Ep with -1.
    mem = _rows(h.slot_members, sidx, -1)  # [Q*Ws, M] full job ids
    ptr_t = torch.as_tensor(ptr, device=dev)
    wl_t = torch.as_tensor(win_len, device=dev)
    jq = torch.clamp(t.job_queue, 0, Q - 1).to(torch.int64)
    s_j = t.job_slot
    in_win = (
        (t.job_queue >= 0) & (s_j >= 0) & (s_j >= ptr_t[jq]) & (s_j < ptr_t[jq] + wl_t[jq])
    )
    ev = torch.nonzero((carry.evict_rank >= 0) & ~in_win).reshape(-1)[:Ep]
    ev_idx = np.full(Ep, -1, dtype=np.int32)
    ev_idx[: ev.shape[0]] = ev.cpu().numpy()
    jidx = np.concatenate([mem.reshape(-1).astype(np.int32), ev_idx])

    pos = np.arange(Q * Ws, dtype=np.int32)
    members_w = np.where(
        mem >= 0, pos[:, None] * M + np.arange(M, dtype=np.int32)[None, :], -1
    ).astype(np.int32)
    starts = (qvec * Ws).astype(np.int32)
    ends = (starts + win_len).astype(np.int32)
    h_w = _window_fields(h, sidx, jidx, members_w, starts, ends)
    sidx_t = torch.as_tensor(sidx, device=dev)
    jidx_t = torch.as_tensor(jidx, device=dev)
    t_w = _window_fields(
        t, sidx_t, jidx_t, torch.as_tensor(members_w, device=dev),
        torch.as_tensor(starts, device=dev), torch.as_tensor(ends, device=dev),
    )
    carry_w = carry._replace(
        job_node=_rows(carry.job_node, jidx_t, NO_NODE),
        job_prio=_rows(carry.job_prio, jidx_t, 0),
        job_evicted=_rows(carry.job_evicted, jidx_t, False),
        job_scheduled=_rows(carry.job_scheduled, jidx_t, False),
        evict_rank=_rows(carry.evict_rank, jidx_t, -1),
        slot_state=_rows(carry.slot_state, sidx_t, 0),
    )
    return h_w, t_w, carry_w, starts.copy(), trunc, win_len, sidx, jidx


def scatter_back(carry, carry_w, ptr_w, sidx, jidx, win_base, Ws: int):
    """Write the window rows back into the full carry, IN PLACE (its job
    and slot tensors are updated and returned; see the module docstring),
    and map the window-local pointers back to full-table positions.
    Queue-, node- and group-axis carry state, and the host loop state,
    are taken wholesale from the window run (they were never split)."""
    dev = carry.job_node.device
    jidx = torch.as_tensor(np.asarray(jidx), device=dev).to(torch.int64)
    sidx = torch.as_tensor(np.asarray(sidx), device=dev).to(torch.int64)
    jl, sl = jidx >= 0, sidx >= 0
    jd, sd = jidx[jl], sidx[sl]
    for name in ("job_node", "job_prio", "job_evicted", "job_scheduled", "evict_rank"):
        getattr(carry, name).index_put_((jd,), getattr(carry_w, name)[jl])
    carry.slot_state.index_put_((sd,), carry_w.slot_state[sl])
    Q = int(np.asarray(win_base).shape[0])
    new_ptr = (
        np.asarray(win_base) + (np.asarray(ptr_w) - np.arange(Q, dtype=np.int32) * Ws)
    ).astype(np.int32)
    merged = carry_w._replace(
        job_node=carry.job_node,
        job_prio=carry.job_prio,
        job_evicted=carry.job_evicted,
        job_scheduled=carry.job_scheduled,
        evict_rank=carry.evict_rank,
        slot_state=carry.slot_state,
    )
    return merged, new_ptr
