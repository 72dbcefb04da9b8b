"""HierarchicalDist with the host stage of every candidate selection
closed by the winner kernel: the counterpart of the JAX package's
`solver/dist_pallas.py` (PallasHierarchicalDist).

The chip stage is unchanged (gather within the host and lex_argmin to one
winner per host). The host stage gathers those winners over the host axis
as before, then reduces the [hosts, K + 2] tuples with `winner_reduce`
(csrc/winner_reduce.cu on a CUDA card, its plain torch version on the
CPU) instead of lex_argmin. The selection does not change: the last key
is the node rank, unique among found rows, so the minimum is unique
however the reduction associates, and not-found rows carry sentinel keys
that lose to any real winner. Each reduction books its exchange into
`CollectiveStats` (`pallas_calls`, `ring_steps`, `ring_bytes`) as the
reference books its tree kernel.
"""

from __future__ import annotations

import torch

from ..ops.kernels import winner_reduce
from .dist import HierarchicalDist


class CudaHierarchicalDist(HierarchicalDist):
    """HierarchicalDist with the host-level winner exchange reduced by
    the winner kernel."""

    def lex_argmin_nodes(self, keys, mask, gids):
        g = self._host_winners(keys, mask, gids)
        wgid, wfound = winner_reduce(g[:-2], g[-2], g[-1], dist=self)
        return torch.where(wfound, wgid, 0).to(torch.int32), wfound
