"""The port's node-sharded round against the JAX package's single-device
round on the rounds of tests/torch_scenarios.py with eviction and gangs,
a fast-fill round with eviction and a gang (eviction_gang: evicted
rebinds and queued fills through the merged step, the gang through node
selection), on 21 nodes padded to the mesh by `pad_nodes`, and on a
market round (`market_round(16, 256)`: price order, market eviction, a
spot price) and rounds under the proportional, priority and deadline
policies, on meshes of 1x1 to 2x2: the same check as
tests/test_torch_multihost.py, in a file of its own so the two run side
by side."""

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.parallel import mesh as ref_mesh
from armada_tpu_torch.parallel.mesh import pad_nodes
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from test_torch_multihost import _twenty_one_nodes, check_sharded_round


@pytest.mark.parametrize(
    "name,mesh,path",
    [
        ("eviction_rebalance", (2, 2), "lax"),
        ("eviction_rebalance", (2, 4), "cuda"),
        ("gang_atomicity", (2, 4), "lax"),
        ("gang_atomicity", (2, 2), "cuda"),
        ("nodes21", (2, 4), "lax"),
        ("nodes21", (2, 4), "cuda"),
        ("eviction_gang_fast", (2, 2), "cuda"),
        ("eviction_gang_fast", (2, 4), "lax"),
        ("market", (1, 1), "lax"),
        ("market", (1, 4), "cuda"),
        ("market", (2, 2), "cuda"),
        ("priority_eviction_gang_fast", (1, 1), "cuda"),
        ("priority_eviction_gang_fast", (2, 2), "cuda"),
        ("deadline_eviction_rebalance", (1, 4), "lax"),
        ("deadline_eviction_rebalance", (2, 2), "cuda"),
        ("proportional_home_away_fast", (2, 2), "lax"),
    ],
)
def test_sharded_round_matches_reference(name, mesh, path):
    run = check_sharded_round(name, mesh, path)
    if "eviction" in name or name == "market":
        assert run.last_stats.selects > 0
    if name.endswith("_fast"):
        assert run.loop_stats["merged_fill_loops"] > 0
    if name == "market":
        # No fill: every queued gang selects its nodes.
        assert run.last_stats.fills == 0 and run.loop_stats["fill_loops"] == 0


def test_pad_nodes_matches_reference():
    ref = _twenty_one_nodes()
    assert ref.node_total.shape[0] == 21
    want = ref_mesh.pad_nodes(ref, 8)
    got = pad_nodes(from_reference_round(dataclasses.asdict(ref)), 8)
    assert got.node_total.shape[0] == 24
    for f in dataclasses.fields(got):
        g = getattr(got, f.name)
        if isinstance(g, np.ndarray):
            w = np.asarray(getattr(want, f.name))
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
    assert pad_nodes(got, 8) is got




def test_gang_workload_selects_through_the_winner_reduction():
    """The bench workload with gangs (chip_smoke.py's gangs_100k, cut to
    600 jobs x 24 nodes): gangs are whole (members share the gang's
    queue and request), the 2x2 sharded round equals the single-device
    one, and every select closes through the winner reduction."""
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    inputs = build_inputs(600, 24, n_running=0, gang_every=8)
    members = {}
    for job in inputs[-1]:
        if job.gang is not None:
            members.setdefault(job.gang.id, []).append(job)
    assert members
    for jobs in members.values():
        assert len(jobs) == jobs[0].gang.cardinality
        assert len({(j.queue, tuple(sorted(j.requests.items()))) for j in jobs}) == 1
    dev = pad_device_round(prep_device_round(build_round_snapshot(*inputs)))
    want = solve_round(dev, device="cpu")
    run = resolve_solver("2x2", "cuda", devices=["cpu"] * 4)
    got = run(pad_nodes(dev, 4))
    for k in want:
        assert np.array_equal(got[k], want[k], equal_nan=True), k
    assert run.last_stats.selects > 0
    assert run.last_stats.pallas_calls == run.last_stats.selects
