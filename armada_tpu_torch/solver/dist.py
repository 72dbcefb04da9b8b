"""Distribution seam for the round kernel, single-device form.

Every kernel entry point takes a `dist` object; `LOCAL` makes all of these
plain indexing on one device. The node-sharded forms (ShardDist,
HierarchicalDist) belong to the multi-GPU slice.

Indices: torch raises on an out-of-range index on the CPU and faults on
CUDA, where JAX clamps gathers and drops scatters. Every helper here
therefore clamps or masks its indices itself, as the docstrings say.
"""

from __future__ import annotations

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


class LocalDist:
    """Single-device execution: all ops are plain indexing."""

    n_shards = 1

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

    def add_col(self, alloc, n, delta):
        """alloc[:, n] += delta ([P, R]) at a global node index (0-d)."""
        return index_add_int(alloc, 1, n.reshape(1), delta.unsqueeze(1))

    def add_row_at(self, alloc, row, n, delta):
        """alloc[row, n] += delta ([R]) at a global node index (0-d)."""
        out = alloc.clone()
        out[row] = index_add_int(out[row], 0, n.reshape(1), delta.unsqueeze(0))
        return out

    def segment_to_nodes(self, contrib, nodes, ln):
        """Sum [J, ...] contributions into their (global) nodes -> local
        node-major array. Rows with out-of-range nodes must be zero."""
        return segment_sum(contrib, torch.clamp(nodes, 0, ln - 1), ln)

    def fill_candidates(self, keys, mask, caps, gids, B, path="lax", nbits=None):
        """The globally best (lex-smallest-key) <=B candidate nodes, in fill
        order: (caps[B'], gids[B']) with caps 0 for masked-out entries. A
        batch of <=B jobs needs at most B nodes, so B candidates suffice."""
        take, _ = _fill_sort(keys, mask, B, path, nbits)
        take = take.to(torch.int64)
        return torch.where(mask[take], caps[take], 0), gids[take]


LOCAL = LocalDist()
