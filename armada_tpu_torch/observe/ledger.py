"""Host-device transfer ledger.

Books the bytes a scheduling round moves between host and device. Every
note_* call is a host-side walk summing the byte sizes of array leaves: no
device sync, no data copy, microseconds against a solve.

Usage: a scope that wants a ledger activates one,

    with round_ledger() as led:
        out = solve_round(dev)
    led.as_dict()  # bytes_up / bytes_down / donated / array counts

and the instrumented seams (solver/kernel.solve_round's upload, readback
and in-place window scatter) call the module-level `note_up` /
`note_down` / `note_donated`, which book into EVERY ledger on the current
thread's stack, so an outer ledger and solve_round's own per-solve ledger
each see a complete picture without a handle threaded through the calls.
With no active ledger the notes are near-free no-ops.

Vocabulary:

- up      - arrays uploaded to the solve's device: every numpy array,
            and every tensor on another device than the solve's; a
            tensor already on the solve's device (a device-resident
            round, snapshot/residency.py) books nothing;
- down    - device results materialized on the host (the solve's numpy
            outputs);
- donated - device buffers the solve updated in place (the hot-window
            scatter back into the full carry): traffic that was not
            copied, booked so the copied-against-in-place split shows.

A tree is walked through dataclasses, NamedTuples, tuples, lists and dict
values; leaves are numpy arrays, numpy scalars and torch tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class TransferLedger:
    bytes_up: int = 0
    arrays_up: int = 0
    bytes_down: int = 0
    arrays_down: int = 0
    donated_bytes: int = 0
    donated_buffers: int = 0
    # Free-form site counters ({"solve.h2d": n, ...}) for debugging which
    # seam booked what; not part of the metric surface.
    sites: dict = field(default_factory=dict)

    def note(self, direction: str, nbytes: int, arrays: int, site: str = ""):
        if direction == "up":
            self.bytes_up += nbytes
            self.arrays_up += arrays
        elif direction == "down":
            self.bytes_down += nbytes
            self.arrays_down += arrays
        elif direction == "donated":
            self.donated_bytes += nbytes
            self.donated_buffers += arrays
        else:  # pragma: no cover - caller bug
            raise ValueError(f"unknown transfer direction {direction!r}")
        if site:
            self.sites[site] = self.sites.get(site, 0) + 1

    def as_dict(self) -> dict:
        """The profile payload (ints only, so it travels through JSON)."""
        return {
            "bytes_up": int(self.bytes_up),
            "arrays_up": int(self.arrays_up),
            "bytes_down": int(self.bytes_down),
            "arrays_down": int(self.arrays_down),
            "donated_bytes": int(self.donated_bytes),
            "donated_buffers": int(self.donated_buffers),
        }


_LOCAL = threading.local()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


@contextlib.contextmanager
def round_ledger(ledger: TransferLedger | None = None):
    """Activate a ledger for the dynamic extent of the block. Nests:
    notes inside book into every ledger on the stack."""
    led = ledger if ledger is not None else TransferLedger()
    stack = _stack()
    stack.append(led)
    try:
        yield led
    finally:
        stack.pop()


def _leaves(tree):
    if isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two torch devices are one, an unindexed CUDA device being
    the current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True

    def index(d):
        return torch.cuda.current_device() if d.index is None else d.index

    return index(a) == index(b)


def _uploads(leaf, device) -> bool:
    """Whether a leaf must travel to `device` (None: to a device other
    than the host's CPU)."""
    if isinstance(leaf, torch.Tensor):
        if device is None:
            return leaf.device.type == "cpu"
        return not same_device(leaf.device, torch.device(device))
    return isinstance(leaf, np.ndarray)


def tree_transfer_size(tree, host_only: bool = False, device=None) -> tuple[int, int]:
    """(bytes, arrays) across a tree's array leaves, from shapes and dtypes
    only. `host_only=True` counts only the leaves an upload to `device`
    moves: every numpy array, and each tensor on another device (with
    `device=None`, each CPU tensor). A tensor already on `device` costs
    nothing to "upload" again, and numpy scalars are not arrays that an
    upload moves."""
    nbytes = 0
    arrays = 0
    for leaf in _leaves(tree):
        if host_only and not _uploads(leaf, device):
            continue
        if isinstance(leaf, torch.Tensor):
            n = leaf.numel() * leaf.element_size()
        else:
            n = leaf.nbytes
        nbytes += int(n)
        arrays += 1
    return nbytes, arrays


def _note(direction: str, tree, site: str, host_only: bool = False, device=None):
    stack = _stack()
    if not stack:
        return
    nbytes, arrays = tree_transfer_size(tree, host_only=host_only, device=device)
    for led in stack:
        led.note(direction, nbytes, arrays, site=site)


def note_up(tree, site: str = "h2d", device=None):
    """Book an upload to `device` (the solve's device; None for "a
    device other than the host's CPU"): only the leaves not already
    there count."""
    _note("up", tree, site, host_only=True, device=device)


def note_down(tree, site: str = "d2h"):
    """Book a device-to-host materialization of every array leaf."""
    _note("down", tree, site)


def note_donated(tree, site: str = "donate"):
    """Book buffers updated in place (no copy moved)."""
    _note("donated", tree, site)
