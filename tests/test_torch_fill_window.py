"""ROADMAP C1 in a round: a batch fill window of 4,096 on more than 4,096
nodes, so that `fill_take` takes 4,096 candidates, past its shared-memory
survivor budget, held to the JAX package's round; in a file of its own so
that it runs beside tests/test_torch_fast_fill*.py. The kernel's own
tests at that width are in tests/test_torch_kernels.py (its plain version
and cluster model) and tests/test_torch_cuda.py (on the card)."""

import dataclasses

import numpy as np
import torch_cpu  # noqa: F401

from armada_tpu.core.config import SchedulingConfig
from armada_tpu.core.types import QueueSpec
from armada_tpu.snapshot.round import build_round_snapshot
from armada_tpu.solver import kernel as ref_kernel
from armada_tpu.solver.kernel_prep import pad_device_round, prep_device_round
from armada_tpu_torch.ops import kernels as tk
from armada_tpu_torch.solver import kernel as port_kernel
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from test_torch_fast_fill import _jobs, _nodes
from test_torch_round import _assert_same


def test_window_4096_round_on_more_nodes_matches_reference():
    """ROADMAP C1: a batch fill window of 4,096 on more than 4,096 nodes
    (8,192 padded), so every fill takes min(B, N) = 4,096 candidates, past
    the kernel's shared-memory survivor budget. The port's "cuda" path
    (fill_take's plain version here: this shows the round's control flow,
    not the kernel, which chip_smoke.py runs on the card) and its "lax"
    path equal the reference's "lax" path."""
    cfg = SchedulingConfig(batch_fill_window=4096)
    queued = _jobs(600, lambda i: f"q{i % 4}", lambda i: str(1 << (i % 4)), lambda i: "2Gi")
    snap = build_round_snapshot(cfg, "default", _nodes(4100, width=4),
                                [QueueSpec(f"q{i}", 1.0) for i in range(4)], [], queued)
    dev = pad_device_round(prep_device_round(snap))
    assert dev.batch_window == 4096 and dev.node_total.shape[0] == 8192
    assert tk.fill_take_config(8192, 4096).global_sort
    want = ref_kernel.solve_round(dataclasses.replace(dev, kernel_path="lax"))
    for ref_path in ("pallas", "lax"):
        port_dev = from_reference_round(
            dataclasses.asdict(dataclasses.replace(dev, kernel_path=ref_path))
        )
        stats = {}
        got = port_kernel.solve_round(port_dev, device="cpu", stats=stats)
        _assert_same(f"window4096/{port_dev.kernel_path}", got, want)
        assert stats["fill_loops"] > 0
        assert int(np.asarray(got["scheduled_mask"]).sum()) == 600
