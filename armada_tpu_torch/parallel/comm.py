"""An in-process shard group: one thread per shard over a grid of named
mesh axes, with the two collectives the node-sharded round needs.

This is the counterpart of the JAX package's single-process mesh
(`shard_map` over XLA devices): every shard runs the same sequential
solve on its own thread, on its own torch device, and the shards meet
only in `all_gather` and `psum` over one mesh axis. For a (hosts, chips)
grid, the chip-axis group of a shard is the shards on its host, and its
host-axis group is the shards with the same chip index. Several shards
may share one device (the tests put every shard on the CPU).

Collectives are one barrier each. A member publishes its tensors into its
slot of the axis group's mailbox, waits at the group's barrier, then reads
every member's slot. Mailboxes alternate between two buffers, so a member
that runs ahead cannot overwrite a slot that another still reads: to
reach the next use of a buffer it must pass a barrier that the slow
member has not reached.

Shards take turns on the host: a shard runs only while it holds the
group's turn, which it gives up while it waits at a barrier. One
interpreter runs one thread's Python at a time anyway; without turns,
every torch call (which releases the interpreter lock) would hand the
lock to another shard, a thread switch per operation. With turns the
switches happen only at collectives. The device work a shard launches is
asynchronous, so turns serialise nothing on the card.

Turns are also what keeps the sharded round bit-exact, not only a speed
measure: ops/segment.py turns torch's process-wide deterministic switch
off around its integer scatter-adds, and a float op that another shard
ran in that window would be non-deterministic. A shard gives up
its turn only while it waits at a barrier, so no other shard runs while
the switch is off. A change that lets shards run side by side (a turn
released around device work, say) must first make that switch safe.

Hand-over between devices and streams is explicit: the producer records
a CUDA event on its current stream after publishing; the consumer makes
its stream for the producer's device wait on that event and marks the
tensor as used there before copying it to its own device.

A shard that raises aborts every barrier of the group, so the others stop
at their next collective and the run raises the first shard's exception.
A wait at a barrier or for the turn that lasts longer than the group's
timeout aborts the group, and the run raises TimeoutError: a stuck shard
makes the solve fail, never hang.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 900.0


class ShardAbort(RuntimeError):
    """Raised in a shard at a collective after the group was aborted: a
    shard failed, or a barrier timed out."""


class _Mailbox:
    """The exchange of one axis group: a barrier and two slot buffers."""

    def __init__(self, size: int, timeout: float):
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = [[None] * size, [None] * size]


class ShardGroup:
    """Shards laid out row-major over `shape` (axis `axis_names[0]` is the
    slowest), shard i on `devices[i]`."""

    def __init__(self, axis_names, shape, devices, timeout: float = DEFAULT_TIMEOUT_S):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} do not match shape {self.shape}")
        self.n_shards = math.prod(self.shape)
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.n_shards:
            raise ValueError(
                f"{len(self.devices)} devices for {self.n_shards} shards {self.shape}"
            )
        self.timeout = float(timeout)
        self._turn = threading.Lock()
        self._mailboxes = {}
        for index in range(self.n_shards):
            for axis in self.axis_names:
                key = self._group_key(index, axis)
                if key not in self._mailboxes:
                    self._mailboxes[key] = _Mailbox(self.axis_size(axis), self.timeout)

    def coords(self, index: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(index, self.shape))

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def _group_key(self, index: int, axis: str):
        pos = self.axis_names.index(axis)
        coords = self.coords(index)
        return axis, coords[:pos] + coords[pos + 1:]

    def abort(self) -> None:
        for box in self._mailboxes.values():
            box.barrier.abort()

    def run(self, fn):
        """fn(shard) on one thread per shard; returns the results in shard
        order, or raises the first shard's exception (TimeoutError when a
        barrier timed out and no shard raised anything else)."""
        n = self.n_shards
        results = [None] * n
        errors = [None] * n
        finished = [0]
        cond = threading.Condition()

        def body(index):
            shard = Shard(self, index)
            try:
                shard._take_turn()
                if shard.device.type == "cuda":
                    torch.cuda.set_device(shard.device)
                results[index] = fn(shard)
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                errors[index] = e
                self.abort()
            finally:
                if shard.holds_turn:
                    shard._give_turn()
                with cond:
                    finished[0] += 1
                    cond.notify_all()

        threads = [
            threading.Thread(target=body, args=(i,), name=f"shard-{i}", daemon=True)
            for i in range(n)
        ]
        for t in threads:
            t.start()

        def failed():
            return [e for e in errors if e is not None and not isinstance(e, ShardAbort)]

        with cond:
            cond.wait_for(lambda: finished[0] == n or any(e is not None for e in errors))
            if failed():
                # The others stop at their next collective.
                cond.wait_for(lambda: finished[0] == n, timeout=self.timeout)
            # Otherwise a barrier timed out: the shard it waited for is
            # stuck outside a collective and is left behind.
        for e in errors:
            if e is not None and not isinstance(e, ShardAbort):
                raise e
        for e in errors:
            if e is not None:
                raise TimeoutError(
                    f"shard group {self.shape}: a collective waited more than "
                    f"{self.timeout} s for a shard"
                ) from e
        if finished[0] != n:
            raise TimeoutError(f"shard group {self.shape}: a shard did not finish")
        return results


class Shard:
    """One shard's view of its group: its index, grid coordinates and
    device, and the collectives over one named axis."""

    def __init__(self, group: ShardGroup, index: int):
        self.group = group
        self.index = index
        self.coords = group.coords(index)
        self.device = group.devices[index]
        self.holds_turn = False
        self._parity = {}

    def _take_turn(self):
        if not self.group._turn.acquire(timeout=self.group.timeout):
            raise ShardAbort(
                f"shard {self.index}: waited more than {self.group.timeout} s for its turn"
            )
        self.holds_turn = True

    def _give_turn(self):
        self.holds_turn = False
        self.group._turn.release()

    def axis_index(self, axis: str) -> int:
        return self.coords[self.group.axis_names.index(axis)]

    def _exchange(self, axis, xs):
        """Publish xs, meet the axis group, return every member's (xs,
        event) in axis-index order."""
        key = self.group._group_key(self.index, axis)
        box = self.group._mailboxes[key]
        par = self._parity.get(axis, 0)
        self._parity[axis] = par ^ 1
        event = None
        if any(x.is_cuda for x in xs):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        box.slots[par][self.axis_index(axis)] = (xs, event)
        self._give_turn()
        try:
            box.barrier.wait()
        except threading.BrokenBarrierError:
            raise ShardAbort(f"shard {self.index}: group aborted at an {axis} collective") from None
        finally:
            self._take_turn()
        return list(box.slots[par])

    def _receive(self, x, event):
        if x.is_cuda:
            stream = torch.cuda.current_stream(x.device)
            stream.wait_event(event)
            x.record_stream(stream)
        return x.to(self.device)

    def all_gather(self, x, axis: str):
        """Every member's x, stacked in axis-index order on this shard's
        device: [n_axis, ...]. x may be a tensor or a list of tensors (one
        barrier for the list); the result has the same form."""
        single = isinstance(x, torch.Tensor)
        xs = (x,) if single else tuple(x)
        parts = self._exchange(axis, xs)
        out = [
            torch.stack([self._receive(p_xs[i], ev) for p_xs, ev in parts])
            for i in range(len(xs))
        ]
        return out[0] if single else out

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
