"""Two-level (hosts, chips) mesh: the node axis sharded over hosts x chips
shards, with every shard-crossing collective in two stages.

The JAX package's counterpart (armada_tpu/parallel/multihost.py) maps the
two axes onto two fabrics, ICI within a host and DCN across hosts; here
they are the axes of the in-process shard group (parallel/comm.py). The
node axis is split host-major (shard host * chips + chip owns that block),
and the solve runs through `HierarchicalDist` ("lax") or
`CudaHierarchicalDist` ("cuda", the host stage closed by the winner
kernel), both bit-identical to the single-device solve.

Devices default to the CUDA cards, one shard per card, and the default
refuses a mesh larger than the card count. A caller puts several shards
on one device only by passing `devices=[...]` explicitly (the CPU tests
pass `["cpu"] * n`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..solver.dist import CollectiveStats, HierarchicalDist
from .mesh import DeviceMesh, cuda_devices, make_node_mesh, node_sharded_solve, sharded_solve

HOST_AXIS = "hosts"
CHIP_AXIS = "chips"
KERNEL_PATHS = ("lax", "cuda")


def make_host_mesh(n_hosts: int, n_chips: int, devices=None) -> DeviceMesh:
    """A 2D (hosts, chips) mesh over the first n_hosts * n_chips devices
    (default: the CUDA cards), host-major."""
    devices = [torch.device(d) for d in (cuda_devices() if devices is None else devices)]
    need = n_hosts * n_chips
    if len(devices) < need:
        raise ValueError(
            f"mesh {n_hosts}x{n_chips} needs {need} devices, have {len(devices)}"
        )
    return DeviceMesh(tuple(devices[:need]), (n_hosts, n_chips), (HOST_AXIS, CHIP_AXIS))


def hierarchical_sharded_solve(mesh: DeviceMesh, kernel_path: str = "cuda"):
    """The round solve over a 2D (hosts, chips) mesh through the
    two-level dist seam; same contract as mesh.sharded_solve (pad the
    node axis to a multiple of hosts * chips first). kernel_path "cuda"
    closes each select's host stage with the winner kernel
    (CudaHierarchicalDist); "lax" keeps HierarchicalDist."""
    if len(mesh.shape) != 2 or mesh.axis_names != (HOST_AXIS, CHIP_AXIS):
        raise ValueError(
            f"expected a ({HOST_AXIS}, {CHIP_AXIS}) mesh, got {mesh.axis_names} "
            f"with shape {mesh.shape}"
        )
    return sharded_solve(mesh.devices, two_level_dist(*mesh.shape, kernel_path))


def two_level_dist(n_hosts: int, n_chips: int, kernel_path: str = "cuda"):
    """The dist template of a (hosts, chips) grid with fresh
    CollectiveStats: "cuda" closes both stages of each select with the
    winner kernel (CudaHierarchicalDist), "lax" keeps HierarchicalDist."""
    if kernel_path not in KERNEL_PATHS:
        raise ValueError(f"kernel_path must be one of {KERNEL_PATHS}, not {kernel_path!r}")
    if kernel_path == "cuda":
        from ..solver.dist_cuda import CudaHierarchicalDist as _Dist
    else:
        _Dist = HierarchicalDist
    return _Dist(HOST_AXIS, CHIP_AXIS, n_hosts, n_chips, stats=CollectiveStats())


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A parsed mesh request: hosts x chips. hosts == 1 selects the 1D
    path (no host axis, no host stage)."""

    hosts: int
    chips: int

    def __post_init__(self):
        if self.hosts <= 0 or self.chips <= 0:
            raise ValueError(f"mesh spec must be positive, got {self.hosts}x{self.chips}")

    @property
    def n_shards(self) -> int:
        return self.hosts * self.chips


def parse_mesh_spec(spec) -> MeshSpec:
    """Accept the mesh spellings of the JAX package: an int (a 1D shard
    count), an "HxC" string ("2x4"), a (hosts, chips) pair, a MeshSpec,
    or a DeviceMesh (1D or 2D)."""
    if isinstance(spec, MeshSpec):
        return spec
    if isinstance(spec, DeviceMesh):
        if len(spec.shape) == 1:
            return MeshSpec(1, spec.shape[0])
        if len(spec.shape) == 2:
            return MeshSpec(*spec.shape)
        raise ValueError(f"unsupported mesh rank {len(spec.shape)}")
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return MeshSpec(int(spec[0]), int(spec[1]))
    if isinstance(spec, str) and "x" in spec.lower():
        hosts, chips = spec.lower().split("x", 1)
        return MeshSpec(int(hosts), int(chips))
    return MeshSpec(1, int(spec))


def resolve_solver(spec, kernel_path: str = "cuda", devices=None):
    """Mesh spec -> solve runner with `.stats`, `.n_shards` and
    `.mesh_shape`, as the JAX package's `resolve_solver`.

    A DeviceMesh passes through as it is. Anything else builds a mesh over
    the first hosts * chips of `devices`, by default the CUDA cards; the
    default raises RuntimeError when there are fewer cards than shards.
    hosts == 1 takes the 1D path, hosts > 1 the two-level one, whose
    host-stage dist `kernel_path` selects (the 1D path has no host stage
    to swap). The round's own kernel path (DeviceRound.kernel_path) is
    separate, as in the JAX package."""
    if isinstance(spec, DeviceMesh):
        parse_mesh_spec(spec)  # refuse ranks other than 1 and 2
        if len(spec.shape) == 2:
            return hierarchical_sharded_solve(spec, kernel_path)
        return node_sharded_solve(spec)
    ms = parse_mesh_spec(spec)
    if devices is None:
        devices = cuda_devices()
        if len(devices) < ms.n_shards:
            raise RuntimeError(
                f"mesh {ms.hosts}x{ms.chips} requested but only {len(devices)} "
                "CUDA cards; pass devices=[...] to place several shards on one device"
            )
    devices = list(devices)
    if len(devices) < ms.n_shards:
        raise ValueError(
            f"mesh {ms.hosts}x{ms.chips} needs {ms.n_shards} devices, have {len(devices)}"
        )
    if ms.hosts == 1:
        return node_sharded_solve(make_node_mesh(devices[: ms.n_shards]))
    return hierarchical_sharded_solve(make_host_mesh(ms.hosts, ms.chips, devices), kernel_path)
