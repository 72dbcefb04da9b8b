"""The multi-process round: one gloo process per shard on the CPU
(armada_tpu_torch/parallel/launcher.py over parallel/pgroup.py).

- Rounds of tests/torch_scenarios.py with eviction and gangs, and 21 nodes
  padded to the mesh, on 1x2 and 2x2 process grids with the "lax" and
  "cuda" host stages, and the home/away round with fast fill on: rank 0's outputs held to the JAX package's
  single-device `solve_round` of the same padded round as
  tests/test_torch_multihost.py holds the in-process group (decisions,
  num_loops and spot_price bit-exact, fair shares within their ULP
  bounds), every rank's outputs equal, and equal bit for bit to the
  in-process group's; the CollectiveStats equal the in-process run's.
- A market round and rounds under the priority and deadline policies,
  the same way; the round file carries their fields.
- The multi-process tool on the market round and on both rounds of
  `mixed_fleet_rounds` (`--round market`, `--round mixed`).
- A worker that raises fails the launch at once, with its traceback.
- The process group's collectives, in 4 processes: list gathers restore
  every dtype bit for bit, psum adds in axis order, unequal shapes raise.
- Backends are explicit: nccl refuses ranks without a card of their own.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu_torch.parallel.launcher import _free_port, launch, load_round, save_round
from armada_tpu_torch.parallel.multihost import resolve_solver
from armada_tpu_torch.solver.validate import validate_round
from test_torch_multihost import _cpu, _port_round, _reference
from test_torch_round import _assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240.0

CASES = [
    (name, mesh, path)
    for name in ("eviction_rebalance", "gang_atomicity", "nodes21")
    for mesh in ((1, 2), (2, 2))
    for path in ("lax", "cuda")
]


@pytest.mark.parametrize("name,mesh,path", CASES)
def test_multiprocess_round_matches_reference(tmp_path, name, mesh, path):
    check_multiprocess_round(tmp_path, name, mesh, path)


def check_multiprocess_round(tmp_path, name, mesh, path):
    _, want = _reference(name)
    dev = _port_round(name, path)
    round_path = save_round(dev, tmp_path / "round.npz")
    t0 = time.monotonic()
    res = launch(round_path, *mesh, devices=_cpu(mesh), backend="gloo", kernel_path=path,
                 timeout_s=TIMEOUT_S, out_dir=tmp_path)
    assert res["ok"], res.get("tails") or res.get("mismatch")
    assert time.monotonic() - t0 < TIMEOUT_S
    got = res["outputs"]
    _assert_same(f"{name}/{mesh}/{path}", got, want)
    assert validate_round(got, dev=dev) is None
    assert res["mismatch"] == []
    assert [w["coords"] for w in res["workers"]] == [
        [h, c] for h in range(mesh[0]) for c in range(mesh[1])
    ]
    inproc = resolve_solver(mesh, kernel_path=path, devices=_cpu(mesh))
    same = inproc(dev)
    for k in same:
        assert np.array_equal(got[k], same[k], equal_nan=True), k
    assert res["collectives"] == inproc.last_stats.as_dict()
    loops = {k: v for k, v in inproc.loop_stats.items() if k.endswith("_loops")}
    assert loops and {k: res["workers"][0]["loop_stats"][k] for k in loops} == loops
    stats = res["collectives"]
    if path == "cuda" and mesh[0] > 1:
        assert stats["pallas_calls"] == stats["selects"]
    if name == "eviction_rebalance":
        assert stats["selects"] > 0
    return res


@pytest.mark.parametrize("mesh,path", [((2, 2), "cuda"), ((1, 2), "lax")])
def test_multiprocess_fast_fill_round_matches_threads(tmp_path, mesh, path):
    """The home/away round with fast fill on (its config's own), in gloo
    processes: rank 0's outputs held to the JAX package's single-device
    round, equal to the in-thread group's, with equal CollectiveStats and
    loop counts, merged fills included."""
    res = check_multiprocess_round(tmp_path, "home_away_fast", mesh, path)
    assert res["workers"][0]["loop_stats"]["merged_fill_loops"] > 0


def test_dcn_dryrun_home_away_on_cpu():
    """The multi-process tool on the home/away round (fast fill on) at a
    small size, two gloo processes on the CPU: one JSON line, parity with
    the single-device solve, merged fills on every rank."""
    r = subprocess.run(
        [sys.executable, "-m", "armada_tpu_torch.tools.dcn_dryrun", "--round", "home_away",
         "--device", "cpu", "--backend", "gloo", "--hosts", "1", "--chips", "2",
         "--nodes", "32", "--jobs", "96", "--timeout", str(TIMEOUT_S)],
        capture_output=True, text=True, timeout=TIMEOUT_S + 60, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["parity"] and report["round"] == "home_away"
    assert all(s["merged_fill_loops"] > 0 for s in report["loop_stats"])


@pytest.mark.parametrize(
    "name,mesh,path",
    [
        ("market", (2, 2), "cuda"),
        ("priority_eviction_gang_fast", (1, 2), "lax"),
        ("deadline_eviction_rebalance", (2, 2), "cuda"),
    ],
)
def test_multiprocess_policy_and_market_rounds_match_reference(tmp_path, name, mesh, path):
    """A market round and fairness-policy rounds in gloo processes: the
    saved round carries the policy and the market fields to every rank."""
    res = check_multiprocess_round(tmp_path, name, mesh, path)
    if name == "market":
        assert res["collectives"]["selects"] > 0 and res["collectives"]["fills"] == 0
        assert np.isfinite(float(res["outputs"]["spot_price"]))


@pytest.mark.parametrize("args,rounds", [
    (["--round", "market", "--nodes", "16", "--jobs", "256"], ("market",)),
    (["--round", "mixed", "--nodes", "64", "--jobs", "256"], ("home_away", "market")),
])
def test_dcn_dryrun_market_and_mixed_on_cpu(args, rounds):
    """The multi-process tool on the market round, and on both rounds of
    `mixed_fleet_rounds` as the reference's worker runs them, in two gloo
    processes on the CPU: one JSON line, parity for every round."""
    r = subprocess.run(
        [sys.executable, "-m", "armada_tpu_torch.tools.dcn_dryrun", *args, "--device", "cpu",
         "--backend", "gloo", "--hosts", "1", "--chips", "2", "--timeout", str(TIMEOUT_S)],
        capture_output=True, text=True, timeout=2 * TIMEOUT_S + 60, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["parity"]
    per_round = report["rounds"] if len(rounds) > 1 else {report["round"]: report}
    assert tuple(per_round) == rounds
    for name, rep in per_round.items():
        assert rep["ok"] and rep["parity"] and rep["round"] == name and rep["scheduled"] > 0
    if rounds == ("market",):
        assert report["preempted"] > 0 and np.isfinite(report["spot_price"])


@pytest.mark.parametrize("name", ["market", "deadline_eviction_rebalance"])
def test_saved_policy_and_market_rounds_load_field_for_field(tmp_path, name):
    """The market fields (slot_price, spot_price_cutoff) and the policy's
    (queue_deadline, the fairness_policy tuple) survive the round file."""
    dev = _port_round(name, "cuda")
    back = load_round(save_round(dev, tmp_path / "round.npz"))
    assert back.fairness_policy == dev.fairness_policy and type(back.fairness_policy) is tuple
    assert back.market_driven == dev.market_driven
    assert type(back.spot_price_cutoff) is type(dev.spot_price_cutoff)
    assert back.spot_price_cutoff == dev.spot_price_cutoff
    for f in ("slot_price", "queue_deadline", "queue_weight"):
        a, b = getattr(dev, f), getattr(back, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if name == "market":
        assert dev.market_driven and dev.slot_price.max() > 0
    else:
        assert dev.fairness_policy[0] == "deadline" and np.isfinite(dev.queue_deadline).any()


def test_saved_round_loads_field_for_field(tmp_path):
    dev = _port_round("nodes21", "cuda")
    back = load_round(save_round(dev, tmp_path / "round.npz"))
    for name, v in vars(dev).items():
        w = getattr(back, name)
        assert type(w) is type(v), name
        if isinstance(v, np.ndarray):
            assert w.dtype == v.dtype and np.array_equal(w, v, equal_nan=True), name
        else:
            assert w == v, name


def test_a_failing_worker_fails_the_launch_at_once(tmp_path):
    """Rank 3 raises at its first collective (a tensor on the meta device
    cannot be staged to the host) while the others wait in it: the
    coordinator kills them at once instead of waiting for the collective
    timeout, and returns the failing worker's traceback."""
    round_path = save_round(_port_round("nodes21", "lax"), tmp_path / "round.npz")
    t0 = time.monotonic()
    res = launch(round_path, 2, 2, devices=["cpu", "cpu", "cpu", "meta"], backend="gloo",
                 kernel_path="lax", timeout_s=TIMEOUT_S, out_dir=tmp_path)
    assert time.monotonic() - t0 < 60.0
    assert not res["ok"] and not res["timed_out"]
    assert res["returncodes"][3] not in (0, None)
    assert "Traceback" in res["tails"][3] and "meta" in res["tails"][3]
    assert "outputs" not in res


def test_nccl_needs_a_card_per_rank(tmp_path, monkeypatch):
    import torch

    from armada_tpu_torch.parallel.pgroup import ProcessShard

    with pytest.raises(ValueError, match="nccl"):
        launch(None, 1, 2, devices=["cpu", "cpu"], backend="nccl", ring_calls=1)
    with pytest.raises(ValueError, match="nccl"):
        launch(None, 1, 2, devices=["cuda:0", "cuda:0"], backend="nccl", ring_calls=1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        launch(None, 1, 2, backend="nccl", ring_calls=1)
    with pytest.raises(RuntimeError, match="one CUDA card per rank"):
        launch(None, 1, 2, devices=["cuda:0", "cuda:1"], backend="nccl", ring_calls=1)
    with pytest.raises(ValueError, match="nccl"):
        ProcessShard(("hosts", "chips"), (1, 1), 0, 1, "tcp://127.0.0.1:1", backend="nccl",
                     device="cpu")
    with pytest.raises(ValueError, match="backend"):
        launch(None, 1, 2, devices=["cpu", "cpu"], backend="mpi", ring_calls=1)


_COLLECTIVES = textwrap.dedent(
    """
    import json, sys
    import torch
    sys.path.insert(0, ROOT)
    from armada_tpu_torch.parallel.pgroup import ProcessShard

    rank = int(sys.argv[1])
    shard = ProcessShard(("hosts", "chips"), (2, 2), rank, 4, sys.argv[2], backend="gloo",
                         device="cpu", timeout_s=60)
    h, c = shard.coords
    special = torch.tensor([0.1 * (rank + 1), -0.0, float("inf"), float("nan"), 5e-324],
                           dtype=torch.float64)
    parts = [
        torch.arange(6, dtype=torch.int32).reshape(2, 3) + 10 * rank,
        special,
        torch.tensor([rank % 2 == 0, True, False]),
        torch.tensor([1.5, rank], dtype=torch.float32),
        torch.full((64,), 200 + rank, dtype=torch.uint8),
        torch.tensor(-(2 ** 62) + rank, dtype=torch.int64),
    ]
    got = shard.all_gather(parts, "hosts")
    chip_sum = shard.psum(torch.tensor([0.1 * (rank + 1)], dtype=torch.float64), "chips")
    any_ = shard.psum(torch.tensor(rank == 3), "hosts")
    error = None
    try:
        shard.all_gather(torch.zeros((2, 3) if c == 0 else (3, 2)), "chips")
    except ValueError as e:
        error = str(e)
    print("RESULT " + json.dumps({
        "dtypes": [str(g.dtype) for g in got],
        "shapes": [list(g.shape) for g in got],
        "ints": got[0].tolist(),
        "float_bits": got[1].view(torch.int64).tolist(),
        "bools": got[2].tolist(),
        "f32_bits": got[3].view(torch.int32).tolist(),
        "u8": got[4][:, 0].tolist(),
        "i64": got[5].tolist(),
        "chip_sum_bits": chip_sum.view(torch.int64).tolist(),
        "any": bool(any_),
        "error": error,
    }), flush=True)
    shard.destroy()
    """
)


def _bits(x):
    return np.asarray(x, np.float64).view(np.int64).tolist()


def test_process_group_collectives():
    port = _free_port()
    code = f"ROOT = {ROOT!r}\n" + _COLLECTIVES
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(r), f"tcp://127.0.0.1:{port}"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for r in range(4)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    results = [json.loads(o.split("RESULT ", 1)[1].splitlines()[0]) for o in outs]
    for rank, r in enumerate(results):
        h, c = divmod(rank, 2)
        members = [c, 2 + c]  # the ranks of this rank's host-axis group
        assert r["dtypes"] == ["torch.int32", "torch.float64", "torch.bool", "torch.float32",
                               "torch.uint8", "torch.int64"]
        assert r["shapes"] == [[2, 2, 3], [2, 5], [2, 3], [2, 2], [2, 64], [2]]
        assert r["ints"] == [(np.arange(6).reshape(2, 3) + 10 * m).tolist() for m in members]
        assert r["float_bits"] == [
            _bits([0.1 * (m + 1), -0.0, np.inf, np.nan, 5e-324]) for m in members
        ]
        assert r["bools"] == [[m % 2 == 0, True, False] for m in members]
        assert r["f32_bits"] == [
            np.asarray([1.5, m], np.float32).view(np.int32).tolist() for m in members
        ]
        assert r["u8"] == [200 + m for m in members]
        assert r["i64"] == [-(2**62) + m for m in members]
        chips = [2 * h, 2 * h + 1]
        assert r["chip_sum_bits"] == _bits([0.1 * (chips[0] + 1) + 0.1 * (chips[1] + 1)])
        assert r["any"] is (c == 1)
        assert r["error"] is not None and "different shapes" in r["error"]
