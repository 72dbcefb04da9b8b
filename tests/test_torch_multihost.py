"""The port's node-sharded round against the JAX package's single-device
round, on the CPU.

Every shard is a thread with its tensors on the CPU (`devices=["cpu"] *
n`); on the "cuda" paths the kernels' plain versions run. The reference is
the JAX package's `solve_round` on the same padded round (lax path), and
the port's sharded solves are held to it:

- decisions (assigned_node, scheduled_priority, scheduled_mask,
  preempted_mask), num_loops and spot_price bit-exact; fair shares within
  4 ULP (16 for the uncapped accumulator), as tests/test_torch_round.py;
- on meshes 1x1, 1x4, 2x2 and 2x4, with the round's kernel path and the
  host-stage dist both "lax" or both "cuda";
- on the mixed-fleet home/away round (`home_away_round(32, 96)`), with
  fast fill off (`fast_fill=False` for both solvers) and, as its own
  cases, with fast fill on as the round's config has it (the merged
  window fill and the evicted-rebind window over sharded nodes: a shard
  of 4 nodes returns fewer candidates than the window of 512);
  tests/test_torch_multihost_rounds.py adds rounds of
  tests/torch_scenarios.py with eviction and gangs, one with fast fill,
  and 21 nodes padded to the mesh by `pad_nodes`.

Also: the shard group's collectives, its turns, its failure and timeout
behaviour, the node split, the pack plan of a shard, CollectiveStats, and
the mesh spellings and device defaults of `resolve_solver`.
"""

import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch_cpu  # noqa: F401
import torch

from armada_tpu.parallel import mesh as ref_mesh
from armada_tpu.parallel.scenarios import home_away_round
from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.ops.kernels import pack_plan
from armada_tpu_torch.parallel import comm
from armada_tpu_torch.parallel.mesh import (
    NODE_AXIS_POS,
    make_node_mesh,
    node_sharded_solve,
    shard_round,
)
from armada_tpu_torch.parallel.multihost import (
    MeshSpec,
    hierarchical_sharded_solve,
    make_host_mesh,
    parse_mesh_spec,
    resolve_solver,
)
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.dist import HierarchicalDist
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from armada_tpu_torch.solver.validate import validate_round
from test_torch_round import _assert_same
from torch_scenarios import SCENARIOS

MESHES = ((1, 1), (1, 4), (2, 2), (2, 4))
PATHS = ("lax", "cuda")


def _cpu(spec):
    return ["cpu"] * parse_mesh_spec(spec).n_shards


def _home_away():
    return prep_device_round(home_away_round(32, 96))


def _scenario(name):
    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    return prep_device_round(build_round_snapshot(cfg, "default", nodes, queues, running, queued))


def _twenty_one_nodes():
    """21 nodes: no power-of-two padding, so pad_nodes grows it to 24."""
    return prep_device_round(home_away_round(21, 48))


def _policy_scenario(name, kind):
    """A round of tests/torch_scenarios.py under fairness policy `kind`
    (deadlines stamped for the deadline policy)."""
    from test_policy import _stamp_deadlines

    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    if kind == "deadline":
        queued = _stamp_deadlines(queued)
    cfg = dataclasses.replace(cfg, fairness_policy_default=kind)
    return prep_device_round(build_round_snapshot(cfg, "default", nodes, queues, running, queued))


def _market():
    from armada_tpu.parallel.scenarios import market_round

    return prep_device_round(market_round(16, 256))


ROUNDS = {
    "home_away": lambda: pad_device_round(_home_away()),
    "home_away_fast": lambda: pad_device_round(_home_away()),
    "eviction_gang_fast": lambda: pad_device_round(_scenario("eviction_gang")),
    "eviction_rebalance": lambda: pad_device_round(_scenario("eviction_rebalance")),
    "gang_atomicity": lambda: pad_device_round(_scenario("gang_atomicity")),
    "nodes21": _twenty_one_nodes,
    # Market and fairness-policy rounds: price order and market eviction;
    # the policies' rank key in the pick, the merged step and the ranks.
    "market": lambda: pad_device_round(_market()),
    "priority_eviction_gang_fast": lambda: pad_device_round(
        _policy_scenario("eviction_gang", "priority")),
    "deadline_eviction_rebalance": lambda: pad_device_round(
        _policy_scenario("eviction_rebalance", "deadline")),
    "proportional_home_away_fast": lambda: dataclasses.replace(
        pad_device_round(_home_away()), fairness_policy=("proportional",)),
}


# The rounds solved with fast fill on; the others with it off.
FAST_ROUNDS = (
    "home_away_fast", "eviction_gang_fast", "priority_eviction_gang_fast",
    "proportional_home_away_fast",
)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(reference DeviceRound padded to 8 shards, reference lax outputs)."""
    dev = ref_mesh.pad_nodes(ROUNDS[name](), 8)
    dev = dataclasses.replace(dev, fast_fill=name in FAST_ROUNDS, kernel_path="lax")
    return dev, {k: np.asarray(v) for k, v in ref_kernel.solve_round(dev).items()}


def _port_round(name, path):
    dev, _ = _reference(name)
    port = from_reference_round(dataclasses.asdict(dev))
    return dataclasses.replace(port, kernel_path=path)


def check_sharded_round(name, mesh, path):
    _, want = _reference(name)
    dev = _port_round(name, path)
    run = resolve_solver(mesh, kernel_path=path, devices=_cpu(mesh))
    got = run(dev)
    _assert_same(f"{name}/{mesh}/{path}", got, want)
    assert validate_round(got, dev=dev) is None
    stats = run.last_stats
    if path == "cuda" and mesh[0] > 1:
        # Every select's host stage went through the winner reduction.
        assert stats.pallas_calls == stats.selects
    else:
        assert stats.pallas_calls == 0
    assert int(np.asarray(got["scheduled_mask"]).sum()) > 0
    return run


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("path", PATHS)
def test_sharded_round_matches_reference(mesh, path):
    run = check_sharded_round("home_away", mesh, path)
    assert run.last_stats.selects > 0 and run.last_stats.fills > 0
    assert run.loop_stats["fill_loops"] > 0 and run.loop_stats["gang_loops"] > 0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("path", PATHS)
def test_sharded_fast_fill_round_matches_reference(mesh, path):
    run = check_sharded_round("home_away_fast", mesh, path)
    assert run.last_stats.fills > 0
    assert run.loop_stats["merged_fill_loops"] > 0 and run.loop_stats["fill_loops"] == 0


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_vector_point_reads_equal_local(mesh):
    """The evicted-rebind window reads W home columns and unschedulable
    flags at once: take_rows over a vector of global node ids (repeats
    included) on a sharded dist equals the single-device column and flag
    reads, and each books one point read."""
    from armada_tpu_torch.solver.dist import LOCAL, CollectiveStats, ShardDist

    rng = np.random.default_rng(5)
    h, c = mesh
    n, n_local = h * c * 6, 6
    alloc = torch.as_tensor(rng.integers(-5, 50, size=(3, n, 4)).astype(np.int32))
    unsched = torch.as_tensor(rng.random(n) < 0.3)
    nodes = torch.as_tensor(rng.integers(0, n, size=40).astype(np.int32))
    want = (alloc[:, nodes.long()].transpose(0, 1), unsched[nodes.long()])
    assert torch.equal(LOCAL.take_rows(alloc.transpose(0, 1), nodes), want[0])
    assert torch.equal(LOCAL.take_rows(unsched, nodes), want[1])
    assert want[0].shape == (40, 3, 4) and want[1].shape == (40,)
    stats = CollectiveStats()
    dist = (ShardDist("chips", c, stats=stats) if h == 1
            else HierarchicalDist("hosts", "chips", h, c, stats=stats))

    def fn(shard):
        bound = dist.bind(shard)
        part = slice(shard.index * n_local, (shard.index + 1) * n_local)
        return (bound.take_rows(alloc[:, part].contiguous().transpose(0, 1), nodes),
                bound.take_rows(unsched[part].contiguous(), nodes))

    for got in comm.ShardGroup(("hosts", "chips"), mesh, ["cpu"] * (h * c)).run(fn):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert stats.point_ops == 2


def test_shard_round_splits_only_node_fields():
    dev = _port_round("home_away", "cuda")
    parts = [shard_round(dev, i, 4) for i in range(4)]
    for f in dataclasses.fields(dev):
        whole = getattr(dev, f.name)
        if f.name in NODE_AXIS_POS:
            pos = NODE_AXIS_POS[f.name]
            joined = np.concatenate([getattr(p, f.name) for p in parts], axis=pos)
            assert np.array_equal(joined, whole), f.name
            assert getattr(parts[1], f.name).shape[pos] == whole.shape[pos] // 4
        else:
            assert all(getattr(p, f.name) is whole for p in parts), f.name
    with pytest.raises(ValueError):
        shard_round(dev, 0, 3)


def test_shard_pack_plan_spans_the_global_node_count():
    """A shard's fused-key plan gives the node rank the width of the
    global node count, as the reference's pack_plan inside shard_map does;
    the whole round with the shard count would widen it."""
    dev = _port_round("home_away", "cuda")
    n = dev.node_total.shape[0]
    whole = port_kernel._Round(dev, torch.device("cpu")).kbits
    assert whole[-1] == (n - 1).bit_length()
    dist = HierarchicalDist("hosts", "chips", 2, 4)
    rd = port_kernel._Round(shard_round(dev, 3, 8), torch.device("cpu"), dist)
    assert rd.kbits == whole
    assert pack_plan(dev, 8) != whole


def _group_run(fn, shape=(2, 4), timeout=30.0):
    names = ("hosts", "chips")
    return comm.ShardGroup(names, shape, ["cpu"] * (shape[0] * shape[1]), timeout).run(fn)


def test_collectives_gather_and_sum_in_axis_order():
    def fn(shard):
        h, c = shard.axis_index("hosts"), shard.axis_index("chips")
        x = torch.tensor([10 * h + c], dtype=torch.int32)
        chips = shard.all_gather(x, "chips")
        hosts, flags = shard.all_gather([x, torch.tensor(c == 1)], "hosts")
        return (
            chips.reshape(-1).tolist(), hosts.reshape(-1).tolist(), flags.tolist(),
            shard.psum(x, "chips").item(), shard.psum(torch.tensor(h == 1 and c == 2), "hosts").item(),
        )

    out = _group_run(fn)
    for index, (chips, hosts, flags, csum, any_) in enumerate(out):
        h, c = divmod(index, 4)
        assert chips == [10 * h + k for k in range(4)]
        assert hosts == [c, 10 + c] and flags == [c == 1] * 2
        assert csum == 4 * 10 * h + 6
        assert any_ is (c == 2)


def test_a_failing_shard_makes_the_group_raise():
    def fn(shard):
        for step in range(50):
            if shard.index == 5 and step == 3:
                raise ValueError("shard 5 failed")
            shard.psum(torch.ones(1), "chips")
            shard.psum(torch.ones(1), "hosts")

    t0 = time.time()
    with pytest.raises(ValueError, match="shard 5 failed"):
        _group_run(fn, timeout=20.0)
    assert time.time() - t0 < 10.0


def test_a_stuck_shard_times_out():
    release = threading.Event()

    def fn(shard):
        if shard.index == 2:
            release.wait(30.0)
        shard.psum(torch.ones(1), "chips")

    t0 = time.time()
    try:
        with pytest.raises(TimeoutError):
            _group_run(fn, timeout=0.5)
        assert time.time() - t0 < 10.0
    finally:
        release.set()


@pytest.mark.parametrize("turns", [True, False])
def test_turns_keep_other_shards_out_while_the_switch_is_off(monkeypatch, turns):
    """index_add_int never turns torch's process-wide deterministic switch
    off (ops/segment.py), so no other shard can see it off while one sums
    integers, with the group's turns or without them: the switch is never
    called and stays on throughout."""
    from armada_tpu_torch.ops import segment

    real = torch.use_deterministic_algorithms
    seen_off, done = threading.Event(), threading.Event()
    calls = []

    def counted_switch(mode, *, warn_only=False):
        calls.append(mode)
        real(mode, warn_only=warn_only)

    def fn(shard):
        if shard.index == 0:
            one = torch.ones(1, dtype=torch.int64)
            for _ in range(50):
                segment.index_add_int(torch.zeros(4, dtype=torch.int64), 0, one, one, True)
            done.set()
        else:
            deadline = time.time() + 2.0
            while time.time() < deadline and not done.is_set():
                if not torch.are_deterministic_algorithms_enabled():
                    seen_off.set()
                time.sleep(0.001)
        shard.psum(torch.ones(1), "chips")

    if not turns:
        monkeypatch.setattr(comm.Shard, "_take_turn", lambda self: None)
        monkeypatch.setattr(comm.Shard, "_give_turn", lambda self: None)
    before = torch.are_deterministic_algorithms_enabled()
    real(True)
    monkeypatch.setattr(torch, "use_deterministic_algorithms", counted_switch)
    try:
        _group_run(fn, shape=(1, 2))
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        real(before)
    assert calls == []
    assert not seen_off.is_set()


def test_a_failing_shard_makes_the_solve_raise(monkeypatch):
    fill = HierarchicalDist.fill_candidates

    def failing(self, *args, **kwargs):
        if self.shard.index == 1:
            raise RuntimeError("fill failed on shard 1")
        return fill(self, *args, **kwargs)

    monkeypatch.setattr(HierarchicalDist, "fill_candidates", failing)
    run = resolve_solver("2x2", kernel_path="lax", devices=_cpu("2x2"))
    t0 = time.time()
    with pytest.raises(RuntimeError, match="fill failed on shard 1"):
        run(_port_round("home_away", "lax"))
    assert time.time() - t0 < 30.0


def test_collective_stats_book_the_two_levels():
    dev = _port_round("home_away", "cuda")
    run = resolve_solver("2x4", kernel_path="cuda", devices=_cpu("2x4"))
    run(dev)
    s = run.stats
    assert (s.n_hosts, s.n_chips) == (2, 4)
    assert s.selects > 0 and s.fills > 0 and s.point_ops > 0
    # One winner tuple per host over the host axis, per chip over the chip axis.
    assert s.per_select_dcn_scalars * 2 == s.per_select_ici_scalars
    assert 0 < s.dcn_bytes < s.ici_bytes
    # P = 2 hosts: one tree step per exchange of (notfound, K keys, gid).
    n_keys = s.per_select_dcn_scalars // 2 - 2
    assert s.ring_steps == s.pallas_calls == s.selects
    assert s.ring_bytes == s.selects * (n_keys + 2) * 4
    assert run.last_stats == s and run.last_stats is not s
    # A 1D mesh books everything as ICI.
    flat = resolve_solver(4, devices=_cpu(4))
    flat(dev)
    assert flat.stats.dcn_bytes == 0 and flat.stats.ici_bytes > 0


def test_two_level_1x4_equals_1d():
    dev = _port_round("home_away", "lax")
    flat = node_sharded_solve(make_node_mesh(["cpu"] * 4))
    two = hierarchical_sharded_solve(make_host_mesh(1, 4, ["cpu"] * 4), "cuda")
    a, b = flat(dev), two(dev)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_parse_mesh_spec():
    assert parse_mesh_spec(8) == MeshSpec(1, 8)
    assert parse_mesh_spec("2x4") == MeshSpec(2, 4)
    assert parse_mesh_spec("2X4") == MeshSpec(2, 4)
    assert parse_mesh_spec((2, 4)) == MeshSpec(2, 4)
    assert parse_mesh_spec(MeshSpec(4, 2)) == MeshSpec(4, 2)
    assert parse_mesh_spec(make_node_mesh(["cpu"] * 4)) == MeshSpec(1, 4)
    assert parse_mesh_spec(make_host_mesh(2, 2, ["cpu"] * 4)) == MeshSpec(2, 2)
    for bad in (0, -2, "0x4", "2x0", (2, -1), "nonsense"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)


def test_resolve_solver_shapes_and_dists():
    flat = resolve_solver(8, devices=_cpu(8))
    assert flat.n_shards == 8 and flat.mesh_shape == (8,)
    two = resolve_solver("2x4", devices=_cpu("2x4"))
    assert two.n_shards == 8 and two.mesh_shape == (2, 4)
    assert two.stats.n_hosts == 2
    with pytest.raises(ValueError):
        resolve_solver("4x4", devices=_cpu("2x4"))
    with pytest.raises(ValueError):
        make_host_mesh(3, 4, ["cpu"] * 8)
    with pytest.raises(ValueError):
        hierarchical_sharded_solve(make_node_mesh(["cpu"] * 8))
    with pytest.raises(ValueError):
        hierarchical_sharded_solve(make_host_mesh(2, 2, ["cpu"] * 4), "pallas")


@pytest.mark.parametrize("cards", [0, 2])
def test_resolve_solver_needs_a_card_per_shard_by_default(monkeypatch, cards):
    """Without devices, shards go one to a CUDA card, and a mesh larger
    than the card count raises instead of doubling shards up."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        resolve_solver("2x2")
    if cards:
        run = resolve_solver("1x2")
        assert [str(d) for d in run.devices] == ["cuda:0", "cuda:1"]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 4)])
def test_cuda_dist_selects_and_books_as_the_pallas_dist(mesh):
    """Three selects through CudaHierarchicalDist (shard threads on the
    CPU, the winner kernel's plain version) and through the JAX package's
    PallasHierarchicalDist (shard_map over the virtual CPU mesh, the tree
    kernel in interpret mode) on the same node-sharded keys, none found
    included: the same (gid, found) and CollectiveStats equal field for
    field. The reference books each select site once when it traces, the
    port each select it runs, so each select runs once."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from armada_tpu.parallel.mesh import shard_map_compat
    from armada_tpu.parallel.multihost import CHIP_AXIS, HOST_AXIS
    from armada_tpu.parallel.multihost import make_host_mesh as ref_host_mesh
    from armada_tpu.solver.dist import CollectiveStats as RefStats
    from armada_tpu.solver.dist_pallas import PallasHierarchicalDist
    from armada_tpu_torch.solver.dist import CollectiveStats
    from armada_tpu_torch.solver.dist_cuda import CudaHierarchicalDist

    h, c = mesh
    n_local = 8
    rng = np.random.default_rng(mesh)
    cases = []
    for share in (0.5, 0.0, 0.1):
        n = h * c * n_local
        keys = [rng.integers(0, 3, size=n).astype(np.int32) for _ in range(2)]
        keys.append(rng.permutation(n).astype(np.int32))
        cases.append((keys, rng.random(n) < share, np.arange(n, dtype=np.int32)))

    ref = PallasHierarchicalDist(HOST_AXIS, CHIP_AXIS, h, c, stats=RefStats())

    def body(*flat):
        ref.stats.begin_trace()
        outs = []
        for i in range(len(cases)):
            k0, k1, k2, mask, gids = flat[5 * i:5 * i + 5]
            gid, found = ref.lex_argmin_nodes([k0, k1, k2], mask, gids)
            outs += [gid, found]
        return tuple(outs)

    spec = PartitionSpec((HOST_AXIS, CHIP_AXIS))
    flat = [jnp.asarray(a) for keys, mask, gids in cases for a in (*keys, mask, gids)]
    fn = shard_map_compat(body, ref_host_mesh(h, c, jax.devices()[:h * c]),
                          in_specs=(spec,) * len(flat), out_specs=PartitionSpec())
    want = [int(x) for x in jax.jit(fn)(*flat)]

    dist = CudaHierarchicalDist(HOST_AXIS, CHIP_AXIS, h, c, stats=CollectiveStats())
    group = comm.ShardGroup((HOST_AXIS, CHIP_AXIS), (h, c), ["cpu"] * (h * c))

    def shard_fn(shard):
        bound = dist.bind(shard)
        s = slice(shard.index * n_local, (shard.index + 1) * n_local)
        outs = []
        for keys, mask, gids in cases:
            gid, found = bound.lex_argmin_nodes(
                [torch.as_tensor(k[s]) for k in keys], torch.as_tensor(mask[s]),
                torch.as_tensor(gids[s]),
            )
            outs += [int(gid), int(found)]
        return outs

    for got in group.run(shard_fn):
        assert got == want
    assert want[3] == 0 and want[2] == 0  # the none-found case
    assert dataclasses.asdict(dist.stats) == dataclasses.asdict(ref.stats)
    assert dist.stats.selects == len(cases) and dist.stats.pallas_calls == len(cases)
