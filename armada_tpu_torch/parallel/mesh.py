"""Node-sharded execution: the node axis of the round split over a mesh of
shards, each shard a thread on its own torch device.

The JAX package shards every per-node tensor over a mesh axis and runs
the same sequential solve on every chip in lockstep inside `shard_map`
(armada_tpu/parallel/mesh.py). The port does the same with an in-process
shard group (parallel/comm.py): every shard runs the round's host loop
on its thread, over its slice of the nodes and the whole job, queue and
slot state, and the dist seam (solver/dist.py) turns the global node
touches into the group's collectives. Shard i owns the i-th contiguous
block of the node axis.

On one card every shard may sit on that card (pass the devices
explicitly); on a box with several cards each shard gets a card of its
own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..observe import ledger
from ..solver.dist import CollectiveStats, ShardDist
from ..solver.kernel import check_slice, solve_shard
from ..solver.kernel_prep import DeviceRound
from .comm import ShardGroup

# Node-axis position of every node-major field of a DeviceRound; every
# other field stays whole on every shard.
NODE_AXIS_POS = {
    "alloc0": 1,
    "node_total": 0,
    "node_taints": 0,
    "node_labels": 0,
    "node_id_rank": 0,
    "node_unschedulable": 0,
    "node_gid": 0,
}


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Shards over named axes: `devices` row-major over `shape` (the
    first axis slowest), one torch device per shard."""

    devices: tuple
    shape: tuple
    axis_names: tuple


def cuda_devices() -> list:
    """Every CUDA card of this machine, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_node_mesh(devices=None) -> DeviceMesh:
    """The 1D "nodes" mesh over `devices` (default: every CUDA card)."""
    devices = tuple(torch.device(d) for d in (cuda_devices() if devices is None else devices))
    if not devices:
        raise ValueError("a node mesh needs at least one device")
    return DeviceMesh(devices, (len(devices),), ("nodes",))


def pad_nodes(dev: DeviceRound, multiple: int) -> DeviceRound:
    """Pad the node axis so it divides the mesh. Padded nodes are inert:
    unschedulable, zero resources, worst id-rank."""
    n = dev.node_total.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return dev
    total = n + pad

    def pad_axis(arr, axis, fill=0):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(np.asarray(arr), widths, constant_values=fill)

    return dataclasses.replace(
        dev,
        alloc0=pad_axis(dev.alloc0, 1),
        node_total=pad_axis(dev.node_total, 0),
        node_taints=pad_axis(dev.node_taints, 0),
        node_labels=pad_axis(dev.node_labels, 0),
        node_id_rank=np.concatenate(
            [np.asarray(dev.node_id_rank), np.arange(n, total, dtype=np.int32)]
        ),
        node_unschedulable=np.concatenate(
            [np.asarray(dev.node_unschedulable), np.ones(pad, dtype=bool)]
        ),
        node_gid=np.arange(total, dtype=np.int32),
        affinity_allowed=_pad_words(dev.affinity_allowed, total),
    )


def _pad_words(aw: np.ndarray, n_nodes: int) -> np.ndarray:
    """Grow the node-bitset word axis to cover n_nodes global ids."""
    aw = np.asarray(aw)
    need = (n_nodes + 31) // 32
    if aw.shape[1] >= need:
        return aw
    return np.pad(aw, [(0, 0), (0, need - aw.shape[1])])


def shard_round(dev: DeviceRound, index: int, n_shards: int) -> DeviceRound:
    """Shard `index`'s round: the index-th of n_shards equal blocks of
    every node-major field (NODE_AXIS_POS), every other field whole."""
    n = dev.node_total.shape[0]
    if n % n_shards:
        raise ValueError(
            f"{n} nodes do not split over {n_shards} shards; pad_nodes first"
        )
    ln = n // n_shards
    fields = {}
    for name, pos in NODE_AXIS_POS.items():
        arr = np.asarray(getattr(dev, name))
        cut = [slice(None)] * arr.ndim
        cut[pos] = slice(index * ln, (index + 1) * ln)
        fields[name] = arr[tuple(cut)]
    return dataclasses.replace(dev, **fields)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def sharded_solve(devices, dist):
    """A round solve with the node axis sharded over `devices` (one per
    shard, row-major over the dist's mesh shape) through the dist seam.

    Returns run(dev, *, readback_rows=None) -> the decision dict of
    `solve_round`, taken from shard 0 after checking that every shard
    returned the same arrays. `dev` is a padded host DeviceRound whose
    node count divides the shard count (pad_nodes). The callable carries
    `.stats` (the dist's CollectiveStats, counting the latest solve),
    `.last_stats` (a copy of them after the latest solve), `.loop_stats`
    (shard 0's loops by kind and host seconds), `.n_shards`, `.mesh_shape`
    and `.devices`. A shard that raises makes the run raise; a collective
    that waits longer than the shard group's timeout raises TimeoutError."""
    axis_names, shape = dist.mesh_axes()
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != dist.n_shards:
        raise ValueError(f"{len(devices)} devices for a {shape} mesh")

    def run(dev: DeviceRound, *, readback_rows: int | None = None):
        check_slice(dev)
        # The padded host round travels to the shards' devices: booked once
        # on the calling thread's ledgers (the shard threads keep their
        # own), as the JAX package books its mesh placement.
        ledger.note_up(dev, site="mesh.place")
        n = dist.n_shards
        locals_ = [shard_round(dev, i, n) for i in range(n)]
        for d in dict.fromkeys(devices):
            resolve_device(d)
        if dist.stats is not None:
            dist.stats.begin_trace()
        group = ShardGroup(axis_names, shape, devices)

        def shard_fn(shard):
            stats = {}
            out = solve_shard(
                locals_[shard.index], shard.device, dist.bind(shard),
                readback_rows=readback_rows, stats=stats,
            )
            return out, stats

        results = group.run(shard_fn)
        out = results[0][0]
        for i, (other, _) in enumerate(results[1:], start=1):
            for k in out:
                if not _same(out[k], other[k]):
                    raise RuntimeError(f"shard {i} disagrees with shard 0 on {k}")
        run.last_stats = (
            dataclasses.replace(dist.stats) if dist.stats is not None else None
        )
        run.loop_stats = results[0][1]
        return out

    run.stats = dist.stats
    run.last_stats = None
    run.loop_stats = None
    run.n_shards = dist.n_shards
    run.mesh_shape = tuple(shape)
    run.devices = devices
    return run


def node_sharded_solve(mesh: DeviceMesh):
    """The 1D path: every shard is a standalone block of nodes and every
    collective is over the whole "nodes" axis. See parallel/multihost.py
    for the two-level (hosts, chips) form."""
    if mesh.axis_names != ("nodes",):
        raise ValueError(f'a 1D solve mesh must name its axis "nodes", got {mesh.axis_names}')
    dist = ShardDist("nodes", len(mesh.devices), stats=CollectiveStats())
    return sharded_solve(mesh.devices, dist)
