"""The port's own host half against the reference's: from specs equal to
the reference's (rebuilt as the port's types), build_round_snapshot ->
prep_device_round -> pad_device_round gives a DeviceRound equal to the
reference's field by field, dtype included."""

import dataclasses

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.snapshot.round import build_round_snapshot as ref_build
from armada_tpu.solver.kernel_prep import pad_device_round as ref_pad
from armada_tpu.solver.kernel_prep import prep_device_round as ref_prep
from armada_tpu_torch.snapshot.round import build_round_snapshot as port_build
from armada_tpu_torch.solver.kernel_prep import DeviceRound
from armada_tpu_torch.solver.kernel_prep import pad_device_round as port_pad
from armada_tpu_torch.solver.kernel_prep import prep_device_round as port_prep
from armada_tpu_torch.solver.kernel_prep import from_reference_round
from torch_scenarios import SCENARIOS, to_port


def _assert_rounds_equal(name, got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for f in names:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), (name, f)
            assert g.dtype == w.dtype and g.shape == w.shape, (name, f, g.dtype, w.dtype)
            assert np.array_equal(g, w, equal_nan=w.dtype.kind == "f"), (name, f)
        else:
            assert type(g) is type(w) and g == w, (name, f, g, w)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prep_matches_reference(name):
    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    want = ref_pad(ref_prep(ref_build(cfg, "default", nodes, queues, running, queued)))
    port_cfg = to_port(cfg)
    # The port defaults to the fused "cuda" path; compare like for like.
    port_cfg = dataclasses.replace(port_cfg, solve_kernel_path=want.kernel_path)
    got = port_pad(port_prep(port_build(
        port_cfg, "default", to_port(nodes), to_port(queues), to_port(running),
        to_port(queued),
    )))
    _assert_rounds_equal(name, got, want)


def test_port_config_defaults_to_cuda_path():
    cfg, nodes, queues, running, queued = SCENARIOS["random_queued"]()
    port_cfg = to_port(cfg)
    port_cfg = dataclasses.replace(port_cfg, solve_kernel_path="cuda")
    got = port_prep(port_build(
        port_cfg, "default", to_port(nodes), to_port(queues), to_port(running),
        to_port(queued),
    ))
    assert got.kernel_path == "cuda"
    from armada_tpu_torch.core.config import SchedulingConfig

    assert SchedulingConfig().solve_kernel_path == "cuda"


def test_from_reference_round_maps_kernel_paths():
    want = ref_pad(ref_prep(ref_build(*_args("rate_limited"))))
    fields = dataclasses.asdict(want)
    for ref_path, port_path in (
        ("lax", "lax"), ("blocked", "cuda"), ("pallas", "cuda"), ("native", "cuda"),
    ):
        got = from_reference_round({**fields, "kernel_path": ref_path})
        assert isinstance(got, DeviceRound) and got.kernel_path == port_path
    got = from_reference_round(fields)
    _assert_rounds_equal("from_reference_round", got, want)
    with pytest.raises(ValueError):
        from_reference_round({**fields, "kernel_path": "gpu"})


def _args(name):
    cfg, nodes, queues, running, queued = SCENARIOS[name]()
    return cfg, "default", nodes, queues, running, queued
