"""Scatter-adds of integer values, exact and deterministic.

An integer sum is the same in any order. On the "cuda" kernel path these
adds run the hand-written `segment_add` kernel (ops/kernels.py), integer
atomic adds that never read torch's process-wide deterministic switch;
on the CPU the same wrapper takes its plain version, torch's
`index_add`. The "lax" path, the plain version the round is held to,
calls `index_add` itself: torch's CUDA `index_add` then sorts, since
`device.resolve_device` turns the switch on for the float sums. Nothing
here turns the switch off: it is global, and a float scatter that another
thread launched meanwhile (a what-if rollout beside the live round, a
shard of a sharded round) would take torch's atomic path.

Float values are refused: the solver's float accounting sums
integer-valued device units, so it sums them here as int64 and converts,
which gives the float sum bit for bit. The sums wrap as `index_add` does
in the target's width.
"""

from __future__ import annotations

import torch

from . import kernels as K


def index_add_int(x, dim, index, values, kernel):
    """`x.index_add(dim, index, values)` for integer tensors, as a new
    tensor: by the segment kernel when `kernel` (the "cuda" path), else by
    torch's `index_add`."""
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"index_add_int: integer tensors only, not {x.dtype}")
    if index.dtype != torch.int64:
        index = index.to(torch.int64)
    if values.dtype != x.dtype:
        values = values.to(x.dtype)
    if kernel:
        return K.segment_add(x, dim, index, values)
    return x.index_add(dim, index, values)


def segment_sum(values, segments, n, kernel):
    """Sum the rows of integer `values` [K, ...] into `n` segments by
    `segments` [K] (each in [0, n))."""
    out = torch.zeros(
        (n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device
    )
    return index_add_int(out, 0, segments, values, kernel)
