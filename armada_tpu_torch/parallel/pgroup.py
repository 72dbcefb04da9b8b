"""A process shard group: one OS process per shard, with the collectives
of the in-process group (parallel/comm.py) over torch.distributed.

`ProcessShard` is this process's shard of a (hosts, chips) grid laid out
row-major over the ranks, as `torchrun` runs one process per GPU. To the
dist seam (solver/dist.py) it is a drop-in for `comm.Shard`: `index`,
`coords`, `device`, `axis_index`, `all_gather` and `psum` over a named
axis. Every axis group is a `new_group` of its own: for each axis, one
group per line of the grid along it (a host's chips, or one chip index
across the hosts). Every rank creates every subgroup in the same order,
as torch.distributed requires, or the ranks hang.

Backends are chosen by the caller, never silently:
- "gloo" stages every collective through host memory (the tensors go to
  the CPU, the collective runs, the result comes back to the shard's
  device). It is the backend of the CPU tests and of several ranks that
  share one card, which NCCL refuses.
- "nccl" keeps the tensors on the card and needs one card per rank; it
  raises for a shard that is not on a CUDA device.

`all_gather` is one collective per call, for a tensor or a list: the list
is packed into one int64 buffer (float64 viewed bitwise, float32 through
its int32 bits, bool as 0/1, integers widened), behind a header of its
length and a hash of the dtypes and shapes, and split after the gather.
Members pass equal shapes by construction; a header that differs raises.
`psum` is an all_gather and a sum in axis-index order, never all_reduce,
so float sums stay bit-equal to the in-process group; a bool is summed as
int32 and returned as `sum > 0`, as comm.py does.

The group also owns the peer-memory buffers of the ring kernel
(ops/kernels.ring_winner_exchange): one per (axis, row width), made at
first use by a collective over the axis, closed and freed by `destroy`.
A rank owns one shard, so the in-process group's turns have nothing to
guard here.
"""

from __future__ import annotations

import datetime
import hashlib
import itertools
import math

import numpy as np
import torch
import torch.distributed as tdist

from ..ops import kernels
from .comm import DEFAULT_TIMEOUT_S

BACKENDS = ("gloo", "nccl")
_HEADER = 2  # payload length, signature hash


def _signature(xs) -> int:
    """A signed 63-bit hash of the dtypes and shapes of a tensor list."""
    text = repr([(str(x.dtype), tuple(x.shape)) for x in xs]).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1


def _to_words(x):
    """x flattened to int64 words that `_from_words` restores bit for bit."""
    x = x.reshape(-1)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64)
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise TypeError(f"all_gather: unsupported dtype {x.dtype}")
    return x.to(torch.int64)


def _from_words(words, dtype, shape):
    """[n, numel] int64 words -> [n, *shape] of dtype."""
    if dtype == torch.float64:
        out = words.contiguous().view(torch.float64)
    elif dtype == torch.float32:
        out = words.to(torch.int32).view(torch.float32)
    elif dtype == torch.bool:
        out = words != 0
    else:
        out = words.to(dtype)
    return out.reshape((words.shape[0], *shape))


class ProcessShard:
    """This process's shard of a row-major grid over `world_size` ranks,
    joined through torch.distributed at `init_method` (an explicit
    `tcp://127.0.0.1:<port>`). Collectives that wait longer than
    `timeout_s` raise."""

    def __init__(self, axis_names, shape, rank: int, world_size: int, init_method: str,
                 *, backend: str, device, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} do not match shape {self.shape}")
        if math.prod(self.shape) != world_size:
            raise ValueError(f"grid {self.shape} does not hold {world_size} ranks")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
        self.device = torch.device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"nccl needs one CUDA card per rank; rank {rank} is on {self.device}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.backend = backend
        self.index = int(rank)
        self.coords = tuple(int(c) for c in np.unravel_index(self.index, self.shape))
        self._comm_device = self.device if backend == "nccl" else torch.device("cpu")
        timeout = datetime.timedelta(seconds=float(timeout_s))
        tdist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=self.index,
            timeout=timeout,
        )
        self._groups = {}
        for pos, axis in enumerate(self.axis_names):
            others = [range(s) for i, s in enumerate(self.shape) if i != pos]
            for rest in itertools.product(*others):
                ranks = []
                for k in range(self.shape[pos]):
                    coords = list(rest)
                    coords.insert(pos, k)
                    ranks.append(int(np.ravel_multi_index(coords, self.shape)))
                group = tdist.new_group(ranks, timeout=timeout, backend=backend)
                if self.index in ranks:
                    self._groups[axis] = group
        self._rings = {}
        self._warm()

    def _warm(self):
        """One tiny gather per axis right after init, so every subgroup
        connects while the ranks are still in step; checks the layout."""
        me = torch.tensor([self.index], dtype=torch.int64, device=self.device)
        for axis in self.axis_names:
            got = self.all_gather(me, axis).reshape(-1).tolist()
            pos = self.axis_names.index(axis)
            want = []
            for k in range(self.shape[pos]):
                coords = list(self.coords)
                coords[pos] = k
                want.append(int(np.ravel_multi_index(coords, self.shape)))
            if got != want:
                raise RuntimeError(f"rank {self.index}: {axis} group holds ranks {got}, expected {want}")

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def all_gather(self, x, axis: str):
        """Every member's x, stacked in axis-index order on this shard's
        device: [n_axis, ...]. x may be a tensor or a list of tensors (one
        collective for the list); the result has the same form."""
        single = isinstance(x, torch.Tensor)
        xs = [x] if single else list(x)
        words = [_to_words(t) for t in xs]
        payload = sum(int(w.numel()) for w in words)
        header = torch.tensor([payload, _signature(xs)], dtype=torch.int64, device=self.device)
        buf = torch.cat([header] + [w.to(self.device) for w in words]).to(self._comm_device)
        n = self.axis_size(axis)
        out = torch.empty((n, buf.numel()), dtype=torch.int64, device=self._comm_device)
        tdist.all_gather(list(out.unbind(0)), buf, group=self._groups[axis])
        if not torch.equal(out[:, :_HEADER], buf[:_HEADER].expand(n, _HEADER)):
            raise ValueError(
                f"rank {self.index}: members of the {axis} group gathered tensors of "
                f"different shapes or dtypes (this member: "
                f"{[(str(t.dtype), tuple(t.shape)) for t in xs]})"
            )
        out = out[:, _HEADER:].to(self.device)
        parts, at = [], 0
        for t, w in zip(xs, words):
            parts.append(_from_words(out[:, at:at + w.numel()], t.dtype, t.shape))
            at += w.numel()
        return parts[0] if single else parts

    def psum(self, x, axis: str):
        """The sum of every member's x, added in axis-index order; a bool x
        is summed as int32 and returned as `sum > 0`."""
        if x.dtype == torch.bool:
            return self.psum(x.to(torch.int32), axis) > 0
        parts = self.all_gather(x, axis)
        acc = parts[0]
        for i in range(1, parts.shape[0]):
            acc = acc + parts[i]
        return acc

    def ring(self, axis: str, width: int) -> kernels.RingBuffers:
        """This member's ring buffers over `axis` for rows of `width`
        words, made at first use (a collective over the axis)."""
        key = (axis, int(width))
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = kernels.ring_open(self, axis, width)
        return ring

    def barrier(self, axis: str) -> None:
        """Wait for every member of `axis`."""
        group = self._groups[axis]
        if self.backend == "nccl":
            tdist.barrier(group=group, device_ids=[self.device.index])
        else:
            tdist.barrier(group=group)

    def destroy(self) -> None:
        """Free the ring buffers and leave the process group. Per ring, in
        one order on every rank: close every other member's buffer, wait
        for every member of the axis to have closed, free this member's."""
        if self._rings and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for (axis, width) in sorted(self._rings):
            ring = self._rings.pop((axis, width))
            kernels.ring_close(ring)
            self.barrier(axis)
            kernels.ring_free(ring)
        tdist.destroy_process_group()
