"""Device-resident round state: delta updates of persistent device
buffers instead of the per-cycle upload of the whole padded round.

The port's counterpart of armada_tpu/snapshot/residency.py, with its
contract. A fresh solve uploads every field of the padded
:class:`DeviceRound` (`solver/kernel.py`, `_Round`). This module keeps
the padded round on the solve's device across warm cycles and applies
each cycle's delta, already folded into the columnar state by
``snapshot/incremental.py``, as batched updates of the persistent
buffers.

Bit-exactness is by construction, not by re-derivation: every cycle the
host-side padded round a fresh solve would have uploaded is computed
anyway (``IncrementalRound`` maintains it in O(delta)), diffed against
an *owned host mirror* of the device state, and only the changed rows
travel. The mirror is updated with exactly the rows that were written,
so mirror == device bits at all times. ``check_drift`` reads the device
buffers back and verifies that invariant.

The device tree holds exactly what ``_Round`` would have uploaded: the
uint32 bitset fields as their int32 words (``ops/bitset.as_words``),
every other array field in its own dtype. Scalar leaves (the runtime
scalars, the 0-d ``spot_price_cutoff``, ``queue_deadline`` when None)
stay host values, as on the fresh path.

Three update shapes, chosen per field per cycle by transfer cost:

- **row scatter** — the changed rows along the field's diff axis (axis
  1 for ``alloc0``'s node axis, axis 0 elsewhere), uploaded as one
  (index, values) batch padded to a pow4 bucket and written with an
  in-place ``index_copy_``. Bucket padding repeats a real index with
  its own row, so the duplicate writes carry equal values. The buckets
  keep the bytes booked equal to the JAX package's, field by field.
- **slot permutation** — the slot table is resorted whenever a lease
  moves a gang between the running and queued segments, shifting most
  slot rows while changing almost no slot *content*. Each slot carries
  a stable leader (its first member's job row), so the new table is
  mostly a gather of the old one: one int32[S] source map uploads and
  every slot-axis field is gathered on the device (``index_select``),
  with only the residual rows (fresh gangs, segment flips) scattered
  after.
- **wholesale replace** — when the scatter batch would cost more bytes
  than the field itself (narrow fields under heavy churn), the whole
  field uploads afresh.

A structural change (a padded shape regrown past a pow2 boundary, a
static field of the round changed) resets the residency: one full
upload, after which delta cycles resume. Every upload — batches, source
maps, resets — books into the active transfer ledger
(``observe/ledger.py``), so ``bytes_up`` stays the honest before/after
axis, and a solve of the returned tree books no upload.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..observe import ledger as _tledger
from ..ops.bitset import as_words
from ..solver.kernel_prep import _META_FIELDS, DeviceRound, pad_device_round

_DATA_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceRound) if f.name not in _META_FIELDS
)

# Slot-axis fields permuted together when the slot table reshuffles.
_SLOT_FIELDS = (
    "slot_members",
    "slot_count",
    "slot_queue",
    "slot_is_running",
    "slot_req",
    "slot_key_group",
    "slot_jobs_before",
    "slot_run_len",
    "slot_batchable",
    "slot_uni_start",
    "slot_uni_end",
    "slot_price",
    "slot_away",
)

# alloc0 is [P, N, R]: the mutable axis is the node axis.
_AXIS1_FIELDS = ("alloc0",)

# Scatter batches pad to pow4 buckets (64, 256, 1024, ...), as in the
# JAX package, where a bucket bounds the compiled scatter programs.
# Eager torch compiles nothing per shape; the buckets keep the bytes
# each cycle books equal to the reference's.
_BUCKET_FLOOR = 64


def _bucket(k: int) -> int:
    b = _BUCKET_FLOOR
    while b < k:
        b *= 4
    return b


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) and v.ndim >= 1


def _changed_rows(old: np.ndarray, new: np.ndarray, axis: int) -> np.ndarray:
    """Indices along `axis` where any element differs. NaN compares
    unequal to itself, so NaN-carrying rows re-upload every cycle —
    conservative (extra bytes), never incorrect (same bits land)."""
    diff = old != new
    if diff.ndim > 1:
        reduce_axes = tuple(i for i in range(diff.ndim) if i != axis)
        mask = diff.any(axis=reduce_axes)
    else:
        mask = diff
    return np.flatnonzero(mask)


def _bits_equal(a, b) -> bool:
    a = np.asarray(a)
    b = np.asarray(b)
    return (
        a.dtype == b.dtype
        and a.shape == b.shape
        and np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()
    )


def _words(arr: np.ndarray) -> np.ndarray:
    """The array as the device holds it: uint32 bitsets as int32 words."""
    return as_words(arr) if arr.dtype == np.uint32 else np.ascontiguousarray(arr)


def _owned(v: np.ndarray) -> np.ndarray:
    """A contiguous copy that shares no memory with `v`: prep hands out
    views of the IncrementalRound's live columns, which the next delta
    mutates in place."""
    owned = np.ascontiguousarray(v)
    return v.copy() if owned is v else owned


class ResidentRound:
    """The device-resident padded round for one pool, plus its owned
    host mirror.

    ``device_round(inc)`` is the per-cycle sync: idempotent per
    ``IncrementalRound`` generation (retries within a cycle reuse the
    committed tree and book nothing), delta-applied between
    generations, fully reset on any structural change. The returned
    tree's array leaves are tensors on ``device`` (the CUDA card unless
    the caller asks for the CPU); its scalar leaves are host values.
    ``solve_round(tree, host=resident.host_round(), device=...)`` solves
    it and books no upload.

    ``host_round()`` is the numpy twin of the device state, for the
    consumers that must not read the device buffers back: the solve's
    host side, the round firewall and the fairness ledger. Callers must
    not mutate it.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._inc = None
        self._gen = None
        self._host: DeviceRound | None = None
        self._dev: DeviceRound | None = None
        # Last non-cached sync: {"mode": "reset"|"delta", "bytes_up": n,
        # "fields": [...], "permuted": bool}
        self.last_sync: dict = {}

    # ------------------------------------------------------------------

    def host_round(self) -> DeviceRound | None:
        return self._host

    def reset(self):
        """Drop all resident state; the next cycle pays one full upload."""
        self._inc = None
        self._gen = None
        self._host = None
        self._dev = None

    def device_round(self, inc) -> DeviceRound:
        """The device-resident padded round for `inc`'s current
        generation, synced by delta (or a full reset). Call inside the
        round's transfer ledger: every byte that travels host→device
        books here and nowhere else."""
        gen = getattr(inc, "_gen", None)
        if self._dev is not None and self._inc is inc and gen == self._gen:
            return self._dev
        new = pad_device_round(inc.device_round())
        if self._host is None or not self._compatible(new):
            self._full_reset(new)
        else:
            self._delta_sync(new)
        self._inc, self._gen = inc, gen
        return self._dev

    def check_drift(self) -> list[str]:
        """Read the device buffers back and bit-compare them with the
        host mirror (uint32 bitsets through their int32 words). Returns
        the drifted field names — any entry means the resident state can
        no longer be trusted and the caller must reset."""
        if self._dev is None or self._host is None:
            return []
        drifted = []
        for name in _DATA_FIELDS:
            h = getattr(self._host, name)
            if not _is_array(h):
                continue
            d = getattr(self._dev, name).cpu().numpy()
            if not _bits_equal(_words(h), d):
                drifted.append(name)
        return drifted

    # ------------------------------------------------------------------

    def _upload(self, arr: np.ndarray, site: str) -> torch.Tensor:
        """A fresh device copy of a host array, booked as an upload. On
        the CPU the copy is still a copy: the device buffers never share
        memory with the mirror."""
        _tledger.note_up(arr, site=site)
        return torch.from_numpy(_words(arr)).to(self.device, copy=True)

    def _compatible(self, new: DeviceRound) -> bool:
        """Same static fields and same padded shapes and dtypes as the
        mirror — the precondition for delta updates into the existing
        buffers. The mirror is compared, not the returned tree, whose
        static fields a caller may replace (a solve on another kernel
        path) without touching the resident state."""
        for m in _META_FIELDS:
            if getattr(new, m) != getattr(self._host, m):
                return False
        for name in _DATA_FIELDS:
            h = getattr(self._host, name)
            n = getattr(new, name)
            h_arr, n_arr = _is_array(h), _is_array(n)
            if h_arr != n_arr:
                return False
            if h_arr and (h.shape != n.shape or h.dtype != n.dtype):
                return False
        return True

    def _full_reset(self, new: DeviceRound):
        host: dict = {}
        dev: dict = {}
        bytes_up = 0
        for name in _DATA_FIELDS:
            v = getattr(new, name)
            if _is_array(v):
                owned = _owned(v)
                host[name] = owned
                dev[name] = self._upload(owned, "residency.reset")
                bytes_up += owned.nbytes
            else:
                host[name] = v
                dev[name] = v
        self._host = dataclasses.replace(new, **host)
        self._dev = dataclasses.replace(new, **dev)
        self.last_sync = {
            "mode": "reset",
            "bytes_up": int(bytes_up),
            "fields": list(_DATA_FIELDS),
            "permuted": False,
        }

    def _slot_source_map(self, new: DeviceRound) -> np.ndarray | None:
        """int32[S] map: new slot i's content lives at old slot
        source[i] (identity for fresh slots, fixed up by the residual
        scatter). None when the slot table did not reshuffle. Keyed on
        each slot's leader — its first member's job row, which is
        stable across cycles because IncrementalRound never renumbers
        live job rows."""
        old_lead = self._host.slot_members[:, 0]
        new_lead = np.asarray(new.slot_members)[:, 0]
        if np.array_equal(old_lead, new_lead):
            return None
        S = old_lead.shape[0]
        top = int(max(old_lead.max(initial=-1), new_lead.max(initial=-1))) + 1
        lut = np.full(max(top, 1), -1, dtype=np.int64)
        old_valid = old_lead >= 0
        lut[old_lead[old_valid]] = np.flatnonzero(old_valid)
        source = np.arange(S, dtype=np.int32)
        nv = np.flatnonzero(new_lead >= 0)
        src = lut[new_lead[nv]]
        source[nv] = np.where(src >= 0, src, nv).astype(np.int32)
        if np.array_equal(source, np.arange(S, dtype=np.int32)):
            return None
        return source

    def _delta_sync(self, new: DeviceRound):
        bytes_up = 0
        touched: list[str] = []
        source = self._slot_source_map(new)
        if source is not None:
            # One uploaded source map permutes every slot-axis field on
            # the device; the host mirror permutes identically, so the
            # residual diff below only sees true content changes.
            source_dev = self._upload(source, "residency.slot_map")
            bytes_up += source.nbytes
            for name in _SLOT_FIELDS:
                setattr(self._dev, name, getattr(self._dev, name).index_select(0, source_dev))
                setattr(self._host, name, np.ascontiguousarray(getattr(self._host, name)[source]))
        for name in _DATA_FIELDS:
            cur = getattr(self._host, name)
            nxt = getattr(new, name)
            if not _is_array(cur):
                if not self._scalar_equal(cur, nxt):
                    setattr(self._host, name, nxt)
                    setattr(self._dev, name, nxt)
                    touched.append(name)
                continue
            nxt = np.asarray(nxt)
            axis = 1 if name in _AXIS1_FIELDS else 0
            rows = _changed_rows(cur, nxt, axis)
            if rows.size == 0:
                continue
            touched.append(name)
            row_bytes = max(1, cur.nbytes // cur.shape[axis])
            kb = _bucket(int(rows.size))
            if kb * (4 + row_bytes) >= cur.nbytes:
                # The batch would outweigh the field: replace wholesale.
                owned = _owned(nxt)
                setattr(self._dev, name, self._upload(owned, "residency.full"))
                setattr(self._host, name, owned)
                bytes_up += owned.nbytes
                continue
            # Bucket-pad by repeating a real index with its own row:
            # duplicate indices write equal values, so the pad rows are
            # no-ops whatever order the writes land in.
            idx = np.empty(kb, dtype=np.int32)
            idx[: rows.size] = rows
            idx[rows.size:] = rows[0]
            vals = np.ascontiguousarray(np.take(nxt, idx, axis=axis))
            idx_dev = self._upload(idx, "residency.delta").to(torch.int64)
            vals_dev = self._upload(vals, "residency.delta")
            bytes_up += idx.nbytes + vals.nbytes
            getattr(self._dev, name).index_copy_(axis, idx_dev, vals_dev)
            if axis == 1:
                cur[:, rows] = nxt[:, rows]
            else:
                cur[rows] = nxt[rows]
        self.last_sync = {
            "mode": "delta",
            "bytes_up": int(bytes_up),
            "fields": touched,
            "permuted": source is not None,
        }

    @staticmethod
    def _scalar_equal(a, b) -> bool:
        try:
            return _bits_equal(a, b)
        except (TypeError, ValueError):
            return a == b
