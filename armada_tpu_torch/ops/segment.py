"""Scatter-adds of integer values.

An integer sum is the same in any order, so these adds may use the
card's atomic scatter-add. torch's deterministic mode (which
`device.resolve_device` turns on for the float sums) would otherwise send
every `index_add` through its sorting kernel, about a millisecond per
call at 65k nodes on an H100. Float values are refused: the solver's
float accounting sums integer-valued device units, so it sums them here
as int64 and converts, which gives the float sum bit for bit.

The deterministic switch is global to the process: while it is off, any
op that any thread runs then is non-deterministic, and a float
scatter or sum there would break the bit-exactness the round depends on.
The shards of a sharded round (one thread each) are kept out of that
window by the shard group's turns (parallel/comm.py): only the shard that
holds the turn runs, and it gives the turn up only at a collective, never
inside `index_add_int`. The lock does less: it keeps a save and its
restore together, so a thread never reads the switch while another has
it turned off and so always restores the true setting.
"""

from __future__ import annotations

import threading

import torch

_SWITCH_LOCK = threading.Lock()


def index_add_int(x, dim, index, values):
    """`x.index_add(dim, index, values)` for integer tensors, as a new
    tensor, with the order-free (atomic) kernel."""
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"index_add_int: integer tensors only, not {x.dtype}")
    with _SWITCH_LOCK:
        enabled = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(False)
        try:
            return x.index_add(dim, index.to(torch.int64), values.to(x.dtype))
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def segment_sum(values, segments, n):
    """Sum the rows of integer `values` [K, ...] into `n` segments by
    `segments` [K] (each in [0, n))."""
    out = torch.zeros(
        (n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device
    )
    return index_add_int(out, 0, segments, values)
