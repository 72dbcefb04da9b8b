"""HierarchicalDist with both stages of every candidate selection closed by
the winner kernel: the counterpart of the JAX package's
`solver/dist_pallas.py` (PallasHierarchicalDist).

The reference keeps the chip stage (an all_gather of K + 2 scalars over
the chips and a lex-argmin) in XLA, which fuses it, and reduces the
gathered per-host tuples with its Pallas tree kernel. Eager PyTorch fuses
nothing, so each op of that stage costs the host a dispatch. Here the
select's tuple travels as one int32 row in the reference's layout
(`ops/kernels.winner_row`: notfound, the keys with the int32 sentinel
where not found, the gid), and both stages reduce gathered rows with
`winner_reduce` (csrc/winner_reduce.cu on a CUDA card, its plain torch
version on the CPU):

- chip stage: gather the row over the chip axis, reduce the [C, K + 2]
  block to the host's winner row;
- host stage: gather that over the host axis and reduce again; this
  launch also writes the select's (gid, found), which the seam returns as
  they are. It runs on every select, as the reference's winner kernel
  does, also over a host axis of one member.

A chip axis of one member launches nothing: the row is already the
host's winner. The selection does not change: the last key is the node rank, unique
among found rows, so the minimum is unique however the reduction
associates, and when no row is found the kernel keeps row 0, which is
`lex_argmin`'s index 0. `CollectiveStats` book what the reference books:
the select's payload at both levels and one winner exchange of the host
stage (`pallas_calls`, `ring_steps`, `ring_bytes`, `pallas_vmem_bytes`);
the chip-stage launch books nothing.
"""

from __future__ import annotations

from ..ops.kernels import winner_reduce_rows, winner_row
from .dist import HierarchicalDist


class CudaHierarchicalDist(HierarchicalDist):
    """HierarchicalDist with the chip and host stages of each select
    reduced by the winner kernel."""

    def lex_argmin_nodes(self, keys, mask, gids):
        row = winner_row(keys, mask, gids)
        self._book_select(keys, ("ici", "dcn"))
        self._book_winner(len(keys))
        if self.n_chips > 1:
            row = winner_reduce_rows(self.shard.all_gather(row, self.chip_axis))
        _, gid, found = winner_reduce_rows(self.shard.all_gather(row, self.host_axis), pick=True)
        return gid, found

    def _book_winner(self, n_keys):
        """The reference's booking of one host-stage winner exchange
        (`_book_winner`, `armada_tpu/ops/pallas_kernels.py:503-513`): P,
        the host count rounded up to a power of two, gives log2(P) tree
        steps (at least one), each moving one (notfound, keys, gid) int32
        tuple; the P rows count as VMEM bytes."""
        if self.stats is None:
            return
        p = 1 << max(0, (self.n_hosts - 1).bit_length())
        steps = max(1, (p - 1).bit_length())
        row_bytes = (n_keys + 2) * 4
        self.stats.pallas_calls += 1
        self.stats.ring_steps += steps
        self.stats.ring_bytes += steps * row_bytes
        self.stats.pallas_vmem_bytes += p * row_bytes
