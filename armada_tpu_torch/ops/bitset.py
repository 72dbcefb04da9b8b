"""Bitset predicates on 32-bit word arrays (vectorized over leading axes).

The words are carried as int32 views of the host's uint32 bitsets: `&`,
`|`, `~` and `== 0` do not depend on the sign, so every predicate here is
exact on the view (torch's CPU build has no `~` on uint32).
"""

from __future__ import annotations

import numpy as np
import torch


def as_words(bits: np.ndarray) -> np.ndarray:
    """A uint32 word array as its int32 view (same bytes, no copy)."""
    return np.ascontiguousarray(bits).view(np.int32)


def bits_subset(required, available):
    """True where every set bit of `required` is set in `available`.

    required: [..., W]; available: [..., W] (broadcastable). Used for node
    selectors: job requires labels -> node must carry them all.
    """
    return torch.all((required & ~available) == 0, dim=-1)


def bits_disjoint(a, b):
    """True where `a & b == 0` across all words. Used for taints: node's
    blocking taints must all be tolerated, i.e. taints & ~tolerated == 0."""
    return torch.all((a & b) == 0, dim=-1)
