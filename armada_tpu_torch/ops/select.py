"""Masked lexicographic argmin and sort: the vectorized candidate selection.

Among feasible entries, take the lexicographic argmin of
(key_0, key_1, ..., id_rank), computed by iterative mask refinement, one
masked-min reduction per key level. The same primitive picks the next
queue in the candidate-gang loop (float cost keys).

torch has no lexsort: `lexsort` chains stable sorts from the least
significant key, which gives the same permutation (ties keep index order).
"""

from __future__ import annotations

import torch


def _sentinel(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def masked_min(values, mask):
    """Min of values where mask, else the dtype's max sentinel."""
    return torch.where(mask, values, _sentinel(values.dtype)).min()


def masked_keys(keys, mask):
    """Substitute each key's masked-out entries with its dtype's max
    sentinel, so masked entries sort last under any lexicographic order."""
    return [torch.where(mask, k, _sentinel(k.dtype)) for k in keys]


def lexsort(keys):
    """Indices sorting entries by lexicographic key, first key most
    significant; ties keep index order (a stable sort)."""
    order = None
    for k in reversed(keys):
        kk = k if order is None else k[order]
        o = torch.sort(kk, stable=True).indices
        order = o if order is None else order[o]
    return order


def masked_lexsort(keys, mask):
    """Indices sorting masked entries by lexicographic key (first key
    most significant); masked-out entries sort last."""
    return lexsort(masked_keys(keys, mask))


def lex_argmin(keys, mask):
    """Index of the lexicographically smallest entry among masked entries.

    keys: list of [N] tensors (int or float), most-significant first; the
    last key must be unique among masked entries (e.g. an id rank).
    Returns (index int32 0-d tensor, found bool 0-d tensor); index is 0
    when nothing matches. argmax returns the first maximal index.
    """
    m = mask
    for k in keys:
        best = masked_min(k, m)
        m = m & (k == best)
    found = torch.any(mask)
    idx = torch.argmax(m.to(torch.int8))
    return torch.where(found, idx, 0).to(torch.int32), found
