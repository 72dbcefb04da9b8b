"""tests/test_multichip.py's cases that no port test mirrored, pinned
(ROADMAP C1): its mixed round and its fewer-nodes-than-shards round (the
default cases) and its uneven-shard and random sweeps (slow there), each
on eight shard threads against the JAX package's single-device round on
the same padded round. Its other case, the benchmark scale (opt-in
there), has its counterpart on the card: chip_smoke.py's phase 7, the
flagship's node width on a 2x2 mesh held to one device. The port's
sharded rounds are otherwise held in tests/test_torch_multihost*.py and
tests/test_torch_launcher.py."""

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from torch_conformance import assert_same_round

# (the kind of round, the reference's case)
MULTICHIP = (
    ("mixed", "test_mixed_round_parity"),
    ("fewer_nodes_than_shards", "test_fewer_nodes_than_shards"),
    ("uneven_shards", "test_uneven_shards_parity"),
    ("random_scenarios", "test_random_scenarios_parity"),
)


def _multichip_rounds(kind):
    from test_kernel_parity import rand_scenario
    from test_multichip import _mixed_scenario

    if kind == "mixed":
        return [_mixed_scenario()]
    if kind == "fewer_nodes_than_shards":
        return [_mixed_scenario(n_nodes=4, n_jobs=12)]
    if kind == "uneven_shards":
        return [_mixed_scenario(n_nodes=n, n_jobs=24) for n in (9, 13, 27)]
    rng = np.random.default_rng(7)
    return [rand_scenario(rng, with_running=True, with_gangs=True) for _ in range(6)]


@pytest.mark.parametrize("kind", [k for k, _ in MULTICHIP])
def test_multichip_case_matches_reference(kind):
    """The port's round on eight shard threads (a 2x4 mesh, the "cuda"
    path's plain versions) against the JAX package's single-device round
    on the same padded round: what test_multichip.py holds its shard_map
    solve to, with the reference in place of the port's own single
    device."""
    from armada_tpu.parallel.mesh import pad_nodes
    from armada_tpu.snapshot.round import build_round_snapshot
    from armada_tpu.solver.kernel import solve_round
    from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.parallel.multihost import resolve_solver
    from armada_tpu_torch.solver.kernel_prep import from_reference_round
    from test_kernel_parity import PREEMPT_CFG

    run = resolve_solver("2x4", kernel_path="cuda", devices=["cpu"] * 8)
    for i, (nodes, queues, running, queued) in enumerate(_multichip_rounds(kind)):
        snap = build_round_snapshot(PREEMPT_CFG, "default", nodes, queues, running, queued)
        dev = pad_nodes(pad_device_round(prep_device_round(snap)), 8)
        want = {k: np.asarray(v) for k, v in solve_round(dev).items()}
        port = dataclasses.replace(from_reference_round(dataclasses.asdict(dev)),
                                   kernel_path="cuda")
        got = run(port)
        assert_same_round(f"{kind}-{i}", got, want)
        if kind == "mixed":
            assert got["scheduled_mask"].sum() > 0
            assert np.isfinite(got["demand_capped_fair_share"]).all()


def test_every_multichip_case_is_pinned():
    """test_multichip.py's five cases: four pinned here, the benchmark
    scale on the card."""
    import test_multichip

    cases = sorted(t for t in vars(test_multichip) if t.startswith("test_"))
    assert len(cases) == 5
    pinned = [case for _, case in MULTICHIP]
    assert sorted(pinned + ["test_benchmark_scale_parity"]) == cases
