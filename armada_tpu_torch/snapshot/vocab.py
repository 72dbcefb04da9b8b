"""Interning of taints and node labels into fixed bitset vocabularies.

The reference restricts the indexed vocabulary via config (indexedTaints /
indexedNodeLabels, nodedb.go:107-120) and compares strings at match time
(nodematching.go:199-240). Here the vocabulary is interned per snapshot and
matching becomes pure bit arithmetic on uint32 words:

  taints:   node blocks job  iff  node_taint_bits & ~job_tolerated_bits != 0
  selector: node matches job iff  job_selector_bits & ~node_label_bits == 0

Both are exact (not approximations): tolerance of each interned taint is
evaluated per job with full Kubernetes semantics on the host, and a selector
pair absent from the vocabulary can match no node, which is recorded in a
per-job "impossible" flag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import JobSpec, NodeSpec, Taint, Toleration


def _n_words(n_bits: int) -> int:
    return max(1, (n_bits + 31) // 32)


def pack_bits(indices: list[int], n_words: int) -> np.ndarray:
    words = np.zeros(n_words, dtype=np.uint32)
    for i in indices:
        words[i // 32] |= np.uint32(1 << (i % 32))
    return words


@dataclass(frozen=True)
class TaintVocab:
    """Distinct scheduling-blocking taints across the node set."""

    taints: tuple[Taint, ...]

    @staticmethod
    def build(nodes: list[NodeSpec]) -> "TaintVocab":
        seen: dict[Taint, None] = {}
        for node in nodes:
            for taint in node.taints:
                if taint.blocks_scheduling:
                    seen.setdefault(taint, None)
        return TaintVocab(tuple(seen))

    @property
    def n_words(self) -> int:
        return _n_words(len(self.taints))

    def node_bits(self, node: NodeSpec) -> np.ndarray:
        idx = [i for i, t in enumerate(self.taints) if t in node.taints]
        return pack_bits(idx, self.n_words)

    def tolerated_bits(self, tolerations: tuple[Toleration, ...]) -> np.ndarray:
        idx = [
            i
            for i, taint in enumerate(self.taints)
            if any(tol.tolerates(taint) for tol in tolerations)
        ]
        return pack_bits(idx, self.n_words)


@dataclass(frozen=True)
class LabelVocab:
    """Interned (label-key, value) pairs present on nodes.

    Only pairs whose key is actually referenced (by a job selector, the
    node-id label, or a gang uniformity label) need interning; callers pass
    the referenced key set to keep the vocabulary small.
    """

    pairs: tuple[tuple[str, str], ...]
    keys: frozenset[str]

    def __post_init__(self):
        object.__setattr__(
            self, "_pair_index", {p: i for i, p in enumerate(self.pairs)}
        )

    @staticmethod
    def build(nodes: list[NodeSpec], referenced_keys: set[str]) -> "LabelVocab":
        seen: dict[tuple[str, str], None] = {}
        for node in nodes:
            for key, value in node.labels.items():
                if key in referenced_keys:
                    seen.setdefault((key, str(value)), None)
        return LabelVocab(tuple(seen), frozenset(referenced_keys))

    @property
    def n_words(self) -> int:
        return _n_words(len(self.pairs))

    def node_bits(self, node: NodeSpec) -> np.ndarray:
        idx = [
            i
            for i, (key, value) in enumerate(self.pairs)
            if node.labels.get(key) == value
        ]
        return pack_bits(idx, self.n_words)

    def selector_bits(self, selector: dict) -> tuple[np.ndarray, bool]:
        """Returns (required bits, possible). possible=False when the selector
        references a (key, value) no node carries: no node can match."""
        idx = []
        for key, value in (selector or {}).items():
            i = self._pair_index.get((key, str(value)))
            if i is None:
                return np.zeros(self.n_words, dtype=np.uint32), False
            idx.append(i)
        return pack_bits(idx, self.n_words), True


def referenced_label_keys(
    jobs: list[JobSpec], node_id_label: str, extra: set[str] | None = None
) -> set[str]:
    keys = {node_id_label}
    for job in jobs:
        if job.node_selector:
            keys.update(job.node_selector.keys())
        if job.gang is not None and job.gang.node_uniformity_label:
            keys.add(job.gang.node_uniformity_label)
    if extra:
        keys.update(extra)
    return keys
