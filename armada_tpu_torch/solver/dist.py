"""Distribution seam for the round kernel: local vs node-sharded execution.

Every kernel entry point takes a `dist` object. `LOCAL` makes all of these
plain indexing on one device. `ShardDist` (a 1D "nodes" mesh) and
`HierarchicalDist` (a 2D (hosts, chips) mesh) run the same sequential
solve on every shard of a node-sharded round, each shard scanning only
its slice of the nodes, and turn the few global node touches into
collectives of the shard group (parallel/comm.py):

  - candidate selection: per-shard lexicographic argmin, then an
    all_gather of the per-shard winners and an argmin over them;
  - reads of one node's values: masked local gather + psum;
  - binds/evictions: scatter-updates applied only by the owning shard
    (no collective: ownership is a local predicate).

A dist is a template: the sharded runner (parallel/mesh.py) binds one copy
per shard to that shard's view of the group (`bind`).

Indices: torch raises on an out-of-range index on the CPU and faults on
CUDA, where JAX clamps gathers and drops scatters. Every helper here
therefore clamps or masks its indices itself, as the docstrings say.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..ops.kernels import fill_sort_path
from ..ops.segment import index_add_int, segment_sum
from ..ops.select import lex_argmin, lexsort, masked_keys


def _fill_sort(keys, mask, B, path="lax", nbits=None):
    """Indices of the B lexicographically-smallest masked entries (sorted).
    Masked-out entries sort last (shared sentinel keys, ops/select.py).
    The "cuda" path routes the fused single-int64 key through the top-B
    kernel (ops/kernels.fill_sort_path), which equals the stable sort
    index for index; everything else keeps the chained stable sort."""
    if path != "lax":
        return fill_sort_path(keys, mask, B, path, nbits)
    mk = masked_keys(keys, mask)
    return lexsort(mk)[:B], mk


def at(x, i):
    """x[i] for a 0-d index tensor, without reading the index back to
    the host (indexing with a 0-d tensor would synchronise)."""
    return x.index_select(0, i.reshape(1).to(torch.int64)).squeeze(0)


@dataclasses.dataclass
class CollectiveStats:
    """Accounting of the sharded solve's cross-shard traffic, with the
    field names of the JAX package's `CollectiveStats`.

    The JAX package books at trace time: each collective call site in the
    compiled program counts once, however many times the while loop runs
    it. The port has no trace, so it books at run time, from shard 0's
    view: every collective the solve EXECUTED counts, so `selects`,
    `fills`, `point_ops` and the scalar, byte, call and step totals are
    the whole round's (a JAX count times the executions of its site).
    `per_select_dcn_scalars` and `per_select_ici_scalars` describe one
    select, as in the JAX package. Scalars and bytes are those a shard
    receives (fan-in times the payload); a 1D mesh books everything as
    ICI. `pallas_calls`, `ring_steps`, `ring_bytes` and
    `pallas_vmem_bytes` book each winner exchange as the reference's
    `_book_winner` does; `pallas_blocks` stays 0 (the port's scoring
    kernel has no VMEM blocks).
    """

    n_hosts: int = 1
    n_chips: int = 1
    selects: int = 0  # lex_argmin_nodes executions (candidate selection)
    fills: int = 0  # fill_candidates executions (batched best-fit merge)
    point_ops: int = 0  # take/take_col/take_rows psum executions
    ici_scalars: int = 0  # scalars received by one shard, all executions
    dcn_scalars: int = 0
    ici_bytes: int = 0
    dcn_bytes: int = 0
    per_select_dcn_scalars: int = 0
    per_select_ici_scalars: int = 0
    pallas_calls: int = 0
    pallas_blocks: int = 0
    pallas_vmem_bytes: int = 0
    ring_steps: int = 0
    ring_bytes: int = 0

    def begin_trace(self) -> None:
        """Zero the counts (the runner calls this at the start of each
        solve, so after it they describe that solve)."""
        self.selects = self.fills = self.point_ops = 0
        self.ici_scalars = self.dcn_scalars = 0
        self.ici_bytes = self.dcn_bytes = 0
        self.per_select_dcn_scalars = self.per_select_ici_scalars = 0
        self.pallas_calls = self.pallas_blocks = self.pallas_vmem_bytes = 0
        self.ring_steps = self.ring_bytes = 0

    def note(self, level: str, arrays) -> None:
        self.note_sizes(level, [(int(a.numel()), a.element_size()) for a in arrays])

    def note_sizes(self, level: str, sizes) -> None:
        """`note` for arrays given as (elements, bytes per element)."""
        fanin = self.n_chips if level == "ici" else self.n_hosts
        scalars = bytes_ = 0
        for numel, size in sizes:
            n = fanin * numel
            scalars += n
            bytes_ += n * size
        if level == "ici":
            self.ici_scalars += scalars
            self.ici_bytes += bytes_
        else:
            self.dcn_scalars += scalars
            self.dcn_bytes += bytes_

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LocalDist:
    """Single-device execution: all ops are plain indexing."""

    n_shards = 1
    stats = None

    def num_nodes(self, alloc):
        """Global node count, given the (locally visible) alloc[P, n, R]."""
        return alloc.shape[1] * self.n_shards

    def lex_argmin_nodes(self, keys, mask, gids):
        """Global node id of the lexicographically smallest masked entry.
        The last key must be globally unique among masked entries."""
        idx, found = lex_argmin(keys, mask)
        return torch.where(found, at(gids, idx), 0).to(torch.int32), found

    def take(self, x, n):
        """x[n] for a global node index n (0-d tensor); x is node-major."""
        return at(x, n)

    def take_col(self, alloc, n):
        """alloc[:, n] -> [P, R] for a global node index n (0-d tensor)."""
        return alloc.index_select(1, n.reshape(1).to(torch.int64)).squeeze(1)

    def take_rows(self, x, nodes):
        """x[nodes] for global node indices [J]; x is node-major.
        Out-of-range indices (e.g. -1) yield zeros/False."""
        ln = x.shape[0]
        ok = (nodes >= 0) & (nodes < ln)
        v = x[torch.clamp(nodes, 0, ln - 1).to(torch.int64)]
        okb = ok.reshape(ok.shape + (1,) * (v.dim() - 1))
        return torch.where(okb, v, torch.zeros_like(v))

    def add_col(self, alloc, n, delta, kernel):
        """alloc[:, n] += delta ([P, R]) at a global node index (0-d); by
        the segment kernel when `kernel` (ops/segment.py), as below."""
        return index_add_int(alloc, 1, n.reshape(1), delta.unsqueeze(1), kernel)

    def add_row_at(self, alloc, row, n, delta, kernel):
        """alloc[row, n] += delta ([R]) at a global node index (0-d)."""
        out = alloc.clone()
        out[row] = index_add_int(out[row], 0, n.reshape(1), delta.unsqueeze(0), kernel)
        return out

    def segment_to_nodes(self, contrib, nodes, ln, kernel):
        """Sum [J, ...] contributions into their (global) nodes -> local
        node-major array. Rows with out-of-range nodes must be zero."""
        return segment_sum(contrib, torch.clamp(nodes, 0, ln - 1), ln, kernel)

    def fill_candidates(self, keys, mask, caps, gids, B, path="lax", nbits=None):
        """The globally best (lex-smallest-key) <=B candidate nodes, in fill
        order: (caps[B'], gids[B']) with caps 0 for masked-out entries. A
        batch of <=B jobs needs at most B nodes, so B candidates suffice."""
        take, _ = _fill_sort(keys, mask, B, path, nbits)
        take = take.to(torch.int64)
        return torch.where(mask[take], caps[take], 0), gids[take]


LOCAL = LocalDist()


class ShardDist:
    """Node-sharded execution over the 1D mesh axis `axis`.

    All per-node arrays a shard sees are its local slice; job, queue and
    slot arrays are whole and every shard computes identical values for
    them (the collectives below are the only cross-shard data flow, and
    their results are the same on every shard). That is what lets every
    shard's host loop read back the same scalars and take the same
    branches."""

    def __init__(self, axis: str, n_shards: int, stats: CollectiveStats | None = None):
        self.axis = axis
        self.n_shards = n_shards
        # A 1D mesh is a single host: every collective books as ICI.
        self.stats = stats
        self.shard = None
        if stats is not None:
            stats.n_hosts = 1
            stats.n_chips = n_shards

    def mesh_axes(self):
        """(axis names, shape) of the shard group this dist runs on."""
        return (self.axis,), (self.n_shards,)

    def bind(self, shard):
        """This dist for one shard of a running group; only shard 0 books
        the stats, so they count one shard's traffic."""
        bound = copy.copy(self)
        bound.shard = shard
        if shard.index != 0:
            bound.stats = None
        return bound

    def num_nodes(self, alloc):
        return alloc.shape[1] * self.n_shards

    def _shard_index(self):
        return self.shard.axis_index(self.axis)

    def _offset(self, ln):
        return self._shard_index() * ln

    def _psum(self, v):
        """Sum over the shards (a bool is `any`, the group's psum rule);
        exact for point reads, where only the owning shard is non-zero."""
        if self.stats is not None:
            self.stats.point_ops += 1
            self.stats.note("ici", [v])
        return self.shard.psum(v, self.axis)

    def _select_tuple(self, keys, mask, gids):
        """The local winner: (idx, [keys at idx..., found, gid at idx])."""
        lidx, lfound = lex_argmin(keys, mask)
        return lidx, [at(k, lidx) for k in keys] + [lfound, at(gids, lidx)]

    def _book_select(self, keys, levels):
        """Book one select's exchange at `levels`, as the reference does:
        its payload is one element each of the K keys, found (bool) and
        the local index (lex_argmin's int32)."""
        if self.stats is None:
            return
        self.stats.selects += 1
        payload = [(1, k.element_size()) for k in keys] + [(1, 1), (1, 4)]
        for level in levels:
            self.stats.note_sizes(level, payload)
        if not self.stats.per_select_ici_scalars:
            self.stats.per_select_ici_scalars = self.stats.n_chips * (len(keys) + 2)
            if "dcn" in levels:
                self.stats.per_select_dcn_scalars = self.stats.n_hosts * (len(keys) + 2)

    def lex_argmin_nodes(self, keys, mask, gids):
        lidx, tup = self._select_tuple(keys, mask, gids)
        self._book_select(keys, ("ici",))
        g = self.shard.all_gather(tup, self.axis)
        widx, wfound = lex_argmin(g[:-2], g[-2])
        return torch.where(wfound, at(g[-1], widx), 0).to(torch.int32), wfound

    def _owned(self, n, ln):
        """(local index clamped into [0, ln), owned) of global node ids n."""
        local = n - self._offset(ln)
        ok = (local >= 0) & (local < ln)
        return torch.clamp(local, 0, ln - 1), ok

    def take(self, x, n):
        local, ok = self._owned(n, x.shape[0])
        v = at(x, local)
        return self._psum(torch.where(ok, v, torch.zeros_like(v)))

    def take_col(self, alloc, n):
        local, ok = self._owned(n, alloc.shape[1])
        v = alloc.index_select(1, local.reshape(1).to(torch.int64)).squeeze(1)
        return self._psum(torch.where(ok, v, torch.zeros_like(v)))

    def take_rows(self, x, nodes):
        local, ok = self._owned(nodes, x.shape[0])
        v = x[local.to(torch.int64)]
        okb = ok.reshape(ok.shape + (1,) * (v.dim() - 1))
        return self._psum(torch.where(okb, v, torch.zeros_like(v)))

    def add_col(self, alloc, n, delta, kernel):
        local, ok = self._owned(n, alloc.shape[1])
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        return index_add_int(alloc, 1, local.reshape(1), delta.unsqueeze(1), kernel)

    def add_row_at(self, alloc, row, n, delta, kernel):
        local, ok = self._owned(n, alloc.shape[1])
        delta = torch.where(ok, delta, torch.zeros_like(delta))
        out = alloc.clone()
        out[row] = index_add_int(out[row], 0, local.reshape(1), delta.unsqueeze(0), kernel)
        return out

    def segment_to_nodes(self, contrib, nodes, ln, kernel):
        local, ok = self._owned(nodes, ln)
        okb = ok.reshape(ok.shape + (1,) * (contrib.dim() - 1))
        return segment_sum(
            torch.where(okb, contrib, torch.zeros_like(contrib)), local, ln, kernel
        )

    def _local_candidates(self, keys, mask, caps, gids, B, path, nbits):
        """This shard's top-B entries: (masked keys..., caps, gids)."""
        take, mk = _fill_sort(keys, mask, B, path, nbits)
        take = take.to(torch.int64)
        return [k[take] for k in mk] + [torch.where(mask[take], caps[take], 0), gids[take]]

    def _merge(self, cands, axis, B):
        """Gather every member's candidates over `axis` and keep the B
        lexicographically smallest, in order."""
        g = [x.reshape(-1) for x in self.shard.all_gather(cands, axis)]
        order = lexsort(g[:-2])[:B]
        return [x[order] for x in g]

    def fill_candidates(self, keys, mask, caps, gids, B, path="lax", nbits=None):
        """Per-shard top-B by local sort, then an all_gather of the shards'
        candidates and a merge sort of them. The global top-B is within
        the union of the local top-Bs, and the last key (the node rank) is
        unique, so the merge equals the single-device sort."""
        cands = self._local_candidates(keys, mask, caps, gids, B, path, nbits)
        if self.stats is not None:
            self.stats.fills += 1
            self.stats.note("ici", cands)
        merged = self._merge(cands, self.axis, B)
        return merged[-2], merged[-1]


class HierarchicalDist(ShardDist):
    """Two-level node sharding for a 2D (hosts, chips) mesh.

    Same seam as ShardDist, with each shard-crossing collective in two
    stages: an all_gather over the chip axis (within a host) and a
    reduction to one winner per host, then an all_gather over the host
    axis of those winners and the final reduction. The stages are exact:
    the last key of every lexicographic reduction is the node rank,
    unique among masked entries, so the two-level argmin and top-B merges
    give exactly the flat (and so the single-device) results; point reads
    add one owning shard's values to zeros, exact in any order.

    Node blocks are host-major: shard host * chips + chip owns block
    host * chips + chip of the node axis."""

    def __init__(self, host_axis: str, chip_axis: str, n_hosts: int, n_chips: int,
                 stats: CollectiveStats | None = None):
        self.host_axis = host_axis
        self.chip_axis = chip_axis
        self.n_hosts = n_hosts
        self.n_chips = n_chips
        self.n_shards = n_hosts * n_chips
        self.stats = stats
        self.shard = None
        if stats is not None:
            stats.n_hosts = n_hosts
            stats.n_chips = n_chips

    def mesh_axes(self):
        return (self.host_axis, self.chip_axis), (self.n_hosts, self.n_chips)

    def _shard_index(self):
        return (
            self.shard.axis_index(self.host_axis) * self.n_chips
            + self.shard.axis_index(self.chip_axis)
        )

    def _psum(self, v):
        # Chip partial sums first, then one partial per host.
        if self.stats is not None:
            self.stats.point_ops += 1
            self.stats.note("ici", [v])
            self.stats.note("dcn", [v])
        return self.shard.psum(self.shard.psum(v, self.chip_axis), self.host_axis)

    def lex_argmin_nodes(self, keys, mask, gids):
        lidx, tup = self._select_tuple(keys, mask, gids)
        self._book_select(keys, ("ici", "dcn"))
        # Chip stage: the host's winner tuple; host stage: the winner of those.
        c = self.shard.all_gather(tup, self.chip_axis)
        hidx, hfound = lex_argmin(c[:-2], c[-2])
        host = [at(k, hidx) for k in c[:-2]] + [hfound, at(c[-1], hidx)]
        g = self.shard.all_gather(host, self.host_axis)
        widx, wfound = lex_argmin(g[:-2], g[-2])
        return torch.where(wfound, at(g[-1], widx), 0).to(torch.int32), wfound

    def fill_candidates(self, keys, mask, caps, gids, B, path="lax", nbits=None):
        """Two-level top-B merge: the chips' top-Bs to a host top-B, the
        hosts' top-Bs to the global top-B. The global top-B is within the
        union of the per-host top-Bs, so the merge is exact, and the
        unique node rank keeps its order equal to the flat sort."""
        cands = self._local_candidates(keys, mask, caps, gids, B, path, nbits)
        if self.stats is not None:
            self.stats.fills += 1
            self.stats.note("ici", cands)
            self.stats.note("dcn", cands)
        host = self._merge(cands, self.chip_axis, B)
        merged = self._merge(host, self.host_axis, B)
        return merged[-2], merged[-1]
