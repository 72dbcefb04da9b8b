"""Multi-process shard group: the node-sharded round with one OS process
per shard, joined through torch.distributed.

The counterpart of the JAX package's `armada_tpu/parallel/launcher.py`,
which runs one process per mesh host with its chips as local devices.
Here, as `torchrun` does, a rank owns one shard: hosts x chips workers,
row-major over the (hosts, chips) grid, each on its own device, meeting
in the collectives of parallel/pgroup.py. On a box with a card per rank
the chip axis is NCCL over NVLink; several ranks on one card (or on the
CPU) share it over gloo.

Entry points:
  - `launch(...)` (coordinator): saves nothing itself; it spawns the
    workers on a round that `save_round` wrote, polls them, kills them
    all as soon as one fails or past the timeout, checks that every rank
    returned the same outputs, and returns rank 0's with every report.
  - `python -m armada_tpu_torch.parallel.launcher --rank R ...` (worker):
    joins the group, solves its shard of the round through the dist seam
    (solver/dist.py), optionally drives the ring kernel over each axis,
    writes `out_dir/rank{R}.npz` and prints one `TORCH_WORKER {json}`
    line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
MARK = "TORCH_WORKER "
RING_KEYS = (1, 3, 5)
RING_SHARES = (0.0, 0.5, 1.0)
RING_SEED = 0
_I32_MAX = int(np.iinfo(np.int32).max)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The round on disk: every rank solves the identical padded round
# ---------------------------------------------------------------------------


def save_round(dev, path) -> str:
    """Write a padded DeviceRound as one .npz: numpy arrays and numpy
    scalars as arrays, every other field (Python scalars, tuples, None) as
    JSON, so `load_round` rebuilds each field with its type."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(dev):
        v = getattr(dev, f.name)
        if isinstance(v, np.ndarray):
            arrays[f"a:{f.name}"] = v
        elif isinstance(v, np.generic):
            arrays[f"s:{f.name}"] = np.asarray(v)
        else:
            statics[f.name] = [type(v).__name__, list(v) if isinstance(v, tuple) else v]
    arrays["statics"] = np.frombuffer(json.dumps(statics).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    return str(path)


def load_round(path):
    """The DeviceRound that `save_round` wrote."""
    from ..solver.kernel_prep import DeviceRound

    kw = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key.startswith("a:"):
                kw[key[2:]] = z[key]
            elif key.startswith("s:"):
                kw[key[2:]] = z[key][()]
        statics = json.loads(z["statics"].tobytes().decode())
    for name, (kind, v) in statics.items():
        kw[name] = tuple(v) if kind == "tuple" else v
    return DeviceRound(**kw)


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def make_dist(n_hosts: int, n_chips: int, kernel_path: str):
    """The dist template of a hosts x chips process grid, as
    `multihost.resolve_solver` picks it: one host is the 1D path (every
    collective over the chips; no host stage for `kernel_path` to pick),
    more hosts the two-level path."""
    from ..solver.dist import CollectiveStats, ShardDist
    from .multihost import CHIP_AXIS, KERNEL_PATHS, two_level_dist

    if n_hosts > 1:
        return two_level_dist(n_hosts, n_chips, kernel_path)
    if kernel_path not in KERNEL_PATHS:
        raise ValueError(f"kernel_path must be one of {KERNEL_PATHS}, not {kernel_path!r}")
    return ShardDist(CHIP_AXIS, n_chips, stats=CollectiveStats())


def _solve(shard, round_path, kernel_path, readback_rows):
    """This rank's shard of the saved round; returns (outputs, report)."""
    import torch

    from ..ops import kernels
    from ..solver.kernel import check_slice, solve_shard
    from .mesh import shard_round

    dev = load_round(round_path)
    check_slice(dev)
    n_hosts, n_chips = shard.shape
    dist = make_dist(n_hosts, n_chips, kernel_path)
    local = shard_round(dev, shard.index, n_hosts * n_chips)
    dist.stats.begin_trace()
    bound = dist.bind(shard)
    kernels.reset_launches()
    loop_stats = {}
    t0 = time.monotonic()
    out = solve_shard(local, shard.device, bound, readback_rows=readback_rows, stats=loop_stats)
    if shard.device.type == "cuda":
        torch.cuda.synchronize(shard.device)
    report = {
        "solve_s": time.monotonic() - t0,
        "loops": int(out["num_loops"]),
        "loop_stats": loop_stats,
        "launches": dict(kernels.LAUNCHES),
        "collectives": bound.stats.as_dict() if bound.stats is not None else None,
    }
    return out, report


def ring_rows(seed, n: int, n_keys: int, found_share: float) -> np.ndarray:
    """Winner tuples of n ring members, int32[n, n_keys + 2], as
    `ops/kernels.winner_rows` builds them: (notfound, keys..., gid) with
    duplicate-heavy leading keys, a permutation (the node rank) as the
    last key, and the int32 sentinel in every key of a not-found row, so
    not-found rows tie. Every member draws the same matrix from `seed`."""
    rng = np.random.default_rng(seed)
    found = rng.random(n) < found_share
    keys = [rng.integers(0, 3, size=n) for _ in range(n_keys - 1)]
    keys.append(rng.permutation(n))
    cols = [np.where(found, 0, 1)] + [np.where(found, k, _I32_MAX) for k in keys]
    cols.append(rng.permutation(n) + 7)
    return np.stack(cols, axis=1).astype(np.int32)


def _ring(shard, calls):
    """Drive the ring kernel over every axis: for each K in RING_KEYS and
    found share in RING_SHARES, `calls` calls with fresh rows, each held
    to the plain version's row on this member. Returns (arrays, report):
    the rows and results of every call, and per axis the checks, the
    launches and, on a card, the times at K = 3, found share 1/2."""
    import torch

    from ..ops import kernels
    from ..timing import cuda_ms, device_ms

    arrays, report, timed = {}, {}, {}
    for pos, axis in enumerate(shard.axis_names):
        n = shard.axis_size(axis)
        me = shard.axis_index(axis)
        kernels.reset_launches()
        cases, mismatches, max_err = [], 0, 0
        for k in RING_KEYS:
            for share in RING_SHARES:
                rows, got = [], []
                for call in range(calls):
                    m = ring_rows((RING_SEED, pos, k, int(share * 2), call), n, k, share)
                    row = torch.as_tensor(m[me], device=shard.device)
                    out = kernels.ring_winner_exchange(row, shard, axis)
                    want = kernels.ring_winner_exchange_plain(row, shard, axis)
                    mismatches += int(not torch.equal(out, want))
                    err = (out.to(torch.int64) - want.to(torch.int64)).abs().max()
                    max_err = max(max_err, int(err))
                    rows.append(m)
                    got.append(out.cpu().numpy())
                tag = f"ring:{axis}:{k}:{share}"
                arrays[f"{tag}:rows"] = np.stack(rows)
                arrays[f"{tag}:got"] = np.stack(got)
                cases.append({"k": k, "found_share": share, "calls": calls})
        entry = {"n": n, "member": me, "cases": cases, "mismatches": mismatches,
                 "max_abs_err": max_err, "launches": kernels.LAUNCHES["ring_exchange"]}
        if shard.device.type == "cuda":
            row = torch.as_tensor(ring_rows((RING_SEED, pos, 3, 1, calls), n, 3, 0.5)[me], device=shard.device)
            entry["ms"] = cuda_ms(lambda: kernels.ring_winner_exchange(row, shard, axis), calls)
            timed[axis] = functools.partial(kernels.ring_winner_exchange, row, shard, axis)
            entry["plain_ms"] = cuda_ms(
                lambda: kernels.ring_winner_exchange_plain(row, shard, axis), calls
            )
            entry["gather_reduce_ms"] = cuda_ms(
                lambda: kernels.winner_reduce_rows(shard.all_gather(row, axis)), calls
            )
        report[axis] = entry
    if timed:
        for axis, ms in device_ms(timed, 20, "ring_exchange_kernel").items():
            report[axis]["device_ms"] = ms
    return arrays, report


def run_worker(args) -> dict:
    """Join the group, solve and/or drive the ring, write rank{R}.npz;
    returns the report that main prints."""
    import torch

    from ..device import resolve_device
    from .multihost import CHIP_AXIS, HOST_AXIS
    from .pgroup import ProcessShard

    device = resolve_device(args.device)
    t0 = time.monotonic()
    shard = ProcessShard(
        (HOST_AXIS, CHIP_AXIS), (args.hosts, args.chips), args.rank,
        args.hosts * args.chips, args.init_method, backend=args.backend, device=device,
        timeout_s=args.timeout,
    )
    print(f"rank {args.rank} of {args.hosts}x{args.chips}: backend {args.backend}, "
          f"device {device}", flush=True)
    report = {"rank": args.rank, "coords": list(shard.coords), "device": str(device),
              "backend": args.backend, "init_s": time.monotonic() - t0, "ok": True}
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    arrays = {}
    # A worker that raises leaves the group as it is: its exit makes the
    # coordinator kill the others, and a teardown would wait for them.
    if args.round:
        out, solved = _solve(shard, args.round, args.kernel_path, args.readback_rows)
        report.update(solved)
        arrays.update({f"out:{k}": np.asarray(v) for k, v in out.items()})
    if args.ring_calls:
        ring_arrays, report["ring"] = _ring(shard, args.ring_calls)
        arrays.update(ring_arrays)
        report["ok"] = all(r["mismatches"] == 0 for r in report["ring"].values())
    shard.destroy()
    np.savez(Path(args.out_dir) / f"rank{args.rank}.npz", **arrays)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one worker of a multi-process round")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--hosts", type=int, required=True)
    ap.add_argument("--chips", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--round", default=None)
    ap.add_argument("--kernel-path", default="cuda")
    ap.add_argument("--readback-rows", type=int, default=None)
    ap.add_argument("--ring-calls", type=int, default=0)
    args = ap.parse_args(argv)
    report = run_worker(args)
    print(MARK + json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------


def default_devices(world: int) -> list:
    """One CUDA card per rank; raises when there are fewer cards."""
    import torch

    count = torch.cuda.device_count()
    if count < world:
        raise RuntimeError(
            f"{world} ranks need {world} CUDA cards, have {count}; pass devices=[...] "
            "to place several ranks on one device (backend gloo)"
        )
    return [f"cuda:{k}" for k in range(world)]


def _check_devices(devices, world, backend) -> list:
    """The device of each rank as a string (default: a card per rank);
    raises for a backend that is not gloo or nccl, and for nccl without a
    card of its own per rank."""
    from .pgroup import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    devices = default_devices(world) if devices is None else [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl":
        import torch

        if any(not d.startswith("cuda") for d in devices) or len(set(devices)) != world:
            raise ValueError(f"nccl needs a CUDA card of its own per rank, got {devices}")
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"nccl needs one CUDA card per rank: {world} ranks, "
                f"{torch.cuda.device_count()} cards"
            )
    return devices


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def launch(round_path, n_hosts: int, n_chips: int, devices=None, backend: str = "gloo",
           kernel_path: str = "cuda", timeout_s: float = 900.0, out_dir=None, *,
           readback_rows: int | None = None, ring_calls: int = 0) -> dict:
    """Run hosts x chips workers on the round saved at `round_path` (None:
    no solve, only the ring drive) and return their merged result.

    `devices` lists one torch device per rank (default: a CUDA card per
    rank, raising when there are fewer). `backend` is "gloo" or "nccl"
    ("nccl" needs a card per rank and raises otherwise). `kernel_path`
    selects the host stage of the two-level dist. `ring_calls` > 0 drives
    the ring kernel that many times per case over every axis after the
    solve. Workers write their arrays under `out_dir` (a temporary
    directory by default) and their logs to temporary files.

    Returns {"ok", "timed_out", "returncodes", "workers" (each rank's
    report, None where it printed none), "seconds", and with a round
    "outputs" (rank 0's decision arrays, after checking every rank's
    equal), "mismatch" (output keys where a rank differed from rank 0),
    "collectives" (rank 0's CollectiveStats), "launches" (summed over the
    ranks); "tails" holds each worker's last output when not ok}. As soon
    as one worker exits non-zero the others are killed; past timeout_s all
    are."""
    world = n_hosts * n_chips
    devices = _check_devices(devices, world, backend)
    with tempfile.TemporaryDirectory(prefix="torch-launch-") as tmp:
        out_dir = Path(out_dir or tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
        logs, procs = [], []
        t0 = time.monotonic()
        try:
            for rank in range(world):
                # Each worker writes to its own file, never a pipe: the ranks
                # advance in step through collectives, so one blocked on a
                # full pipe while the coordinator reads another would stall
                # them all until the timeout.
                logs.append(tempfile.TemporaryFile(mode="w+", prefix=f"torch-worker-{rank}-"))
                cmd = [
                    sys.executable, "-u", "-m", "armada_tpu_torch.parallel.launcher",
                    "--rank", str(rank), "--hosts", str(n_hosts), "--chips", str(n_chips),
                    "--init-method", init_method, "--backend", backend,
                    "--device", devices[rank], "--out-dir", str(out_dir),
                    "--timeout", str(timeout_s), "--kernel-path", kernel_path,
                    "--ring-calls", str(ring_calls),
                ]
                if round_path is not None:
                    cmd += ["--round", str(round_path)]
                if readback_rows is not None:
                    cmd += ["--readback-rows", str(readback_rows)]
                procs.append(subprocess.Popen(
                    cmd, cwd=REPO_ROOT, env=env, stdout=logs[rank], stderr=subprocess.STDOUT,
                    text=True,
                ))
            timed_out = _wait(procs, t0 + timeout_s)
            seconds = time.monotonic() - t0
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
        reports = []
        for text in outputs:
            found = None
            for line in text.splitlines():
                if line.startswith(MARK):
                    found = json.loads(line[len(MARK):])
            reports.append(found)
        codes = [p.returncode for p in procs]
        ok = not timed_out and all(c == 0 for c in codes) and all(
            r is not None and r["ok"] for r in reports
        )
        result = {
            "ok": ok, "timed_out": timed_out, "returncodes": codes, "hosts": n_hosts,
            "chips": n_chips, "backend": backend, "devices": devices,
            "kernel_path": kernel_path, "seconds": seconds, "workers": reports,
        }
        if ok:
            ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
            result["arrays"] = ranks
            if round_path is not None:
                outs = [{k[4:]: v for k, v in r.items() if k.startswith("out:")} for r in ranks]
                mismatch = sorted({
                    k for other in outs[1:] for k in outs[0] if not _same(outs[0][k], other[k])
                })
                result["ok"] = not mismatch
                result["mismatch"] = mismatch
                result["outputs"] = outs[0]
                result["collectives"] = reports[0]["collectives"]
                result["launches"] = {
                    name: sum(r["launches"][name] for r in reports) for name in reports[0]["launches"]
                }
        else:
            result["tails"] = [text[-8000:] for text in outputs]
        return result


def _wait(procs, deadline) -> bool:
    """Poll every worker until all exit 0; kill the rest as soon as one
    exits non-zero, and all of them past the deadline. Returns whether
    the deadline cut the run."""
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return False
        if all(c == 0 for c in codes):
            return False
        if time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return True
        time.sleep(0.05)


if __name__ == "__main__":
    sys.exit(main())
