"""Multi-process parity run: the node-sharded round with one process per
shard against its single-device solve.

The counterpart of the JAX package's `tools/dcn_dryrun.py`, with the same
flags plus `--backend`, `--device` and `--round`. It builds a round, pads
it to the mesh, solves it on one device in this process, launches hosts x
chips workers (parallel/launcher.py) on the same round, and prints
exactly ONE JSON line:

  {"ok": true|false, "timed_out": ..., "hosts": 2, "chips": 4,
   "backend": "gloo", "devices": [...], "parity": true|false,
   "mismatch": [...], "single_solve_s": ..., "seconds": ...,
   "rank_solve_s": [...], "collectives": {...}, "launches": {...}, ...}

Exit code 0 iff ok: every worker exited 0 and rank 0's outputs equal the
single-device solve on every array. The whole run is bounded by
--timeout (hard kill of every worker).

  python -m armada_tpu_torch.tools.dcn_dryrun --hosts 2 --chips 2 --device cpu
  python -m armada_tpu_torch.tools.dcn_dryrun --hosts 2 --chips 2 --device cuda --backend gloo
  python -m armada_tpu_torch.tools.dcn_dryrun --hosts 2 --chips 2 --backend nccl --ring-calls 100
  python -m armada_tpu_torch.tools.dcn_dryrun --round home_away --device cpu --nodes 32 --jobs 96
  python -m armada_tpu_torch.tools.dcn_dryrun --round market --device cpu --nodes 16 --jobs 256
  python -m armada_tpu_torch.tools.dcn_dryrun --round mixed --device cpu --nodes 128 --jobs 512

Rounds (`--round`):
  - bench (default): the bench round with gangs (`workload.build_inputs`:
    nodes of 32 cpu, 10 queues, every 8th queued job opening a gang of 2,
    4 or 8, no running jobs), fast fill off;
  - home_away: the mixed-fleet round of parallel/scenarios.py (borrowed
    away nodes, gangs, two over-packed queues that balance eviction
    evicts), with its config's fast fill on;
  - market: the market pool's round of parallel/scenarios.py (bid order,
    the spot price, market eviction of every bound job, gangs);
  - mixed: both rounds of `mixed_fleet_rounds`, as the JAX package's
    multi-process worker runs them: home/away at --nodes x --jobs, the
    market round at an eighth of it. The line's "ok" and "parity" are
    then those of both, and "rounds" holds each round's own report.

With --ring-calls the workers then drive the ring kernel over every axis
(parallel/launcher.py), each call held to its plain version; "ring"
reports per rank and axis the checks, launches and times.

On the CPU every rank is on the CPU. With --device cuda the ranks go to
the cards round-robin under gloo (several ranks may share one card), and
one card per rank under nccl, which raises when there are fewer cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--jobs", type=int, default=2048)
    ap.add_argument("--timeout", type=float, default=1500.0,
                    help="hard kill for the whole worker fleet, seconds")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--round", choices=("bench", "home_away", "market", "mixed"), default="bench")
    ap.add_argument("--ring-calls", type=int, default=0,
                    help="after the solve, drive the ring kernel this many times per case "
                         "over every axis in the same workers")
    args = ap.parse_args(argv)

    import torch

    from ..ops import kernels
    from ..parallel.mesh import pad_nodes
    from ..parallel.scenarios import home_away_round, market_round, mixed_fleet_rounds
    from ..snapshot.round import build_round_snapshot
    from ..solver.kernel_prep import pad_device_round, prep_device_round
    from ..workload import build_inputs

    world = args.hosts * args.chips
    if args.device == "cpu":
        if args.backend == "nccl":
            ap.error("--backend nccl needs --device cuda (a card per rank)")
        devices = ["cpu"] * world
    else:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("--device cuda: no CUDA card is available")
        # nccl: a card per rank, and launch raises when there are fewer
        devices = None if args.backend == "nccl" else [f"cuda:{k % count}" for k in range(world)]
        kernels.build_all()  # once here, not in every worker
    if args.round == "mixed":
        rounds = mixed_fleet_rounds(args.nodes, args.jobs)
    elif args.round == "home_away":
        rounds = [("home_away", home_away_round(args.nodes, args.jobs))]
    elif args.round == "market":
        rounds = [("market", market_round(args.nodes, args.jobs))]
    else:
        rounds = [("bench", build_round_snapshot(
            *build_inputs(args.jobs, args.nodes, n_running=0, gang_every=8)))]
    reports = [
        _parity(args, name, snap, pad_nodes(pad_device_round(prep_device_round(snap)), world),
                devices)
        for name, snap in rounds
    ]
    if args.round == "mixed":
        report = {
            "ok": all(r["ok"] for r in reports),
            "parity": all(r["parity"] for r in reports),
            "round": "mixed",
            "rounds": {r["round"]: r for r in reports},
        }
    else:
        report = reports[0]
    print(json.dumps(report))
    return 0 if report["ok"] else 1


def _parity(args, name, snap, dev, devices):
    """Solve the padded round `dev` on one device here and in hosts x
    chips workers; the report of the two."""
    from ..parallel.launcher import launch, save_round
    from ..solver.kernel import solve_round

    t0 = time.monotonic()
    single = solve_round(dev, readback_rows=snap.num_jobs, device=args.device)
    single_s = time.monotonic() - t0
    with tempfile.TemporaryDirectory(prefix="dcn-dryrun-") as tmp:
        path = save_round(dev, os.path.join(tmp, "round.npz"))
        res = launch(path, args.hosts, args.chips, devices=devices, backend=args.backend,
                     kernel_path="cuda", timeout_s=args.timeout, out_dir=tmp,
                     readback_rows=snap.num_jobs, ring_calls=args.ring_calls)
    res.pop("arrays", None)
    multi = res.pop("outputs", None)
    mismatch = None if multi is None else sorted(
        k for k in single
        if not np.array_equal(np.asarray(multi[k]), np.asarray(single[k]), equal_nan=True)
    )
    report = {
        **res,
        "ok": bool(res["ok"] and mismatch == []),
        "parity": mismatch == [],
        "single_mismatch": mismatch,
        "round": name,
        "n_nodes": int(snap.num_nodes),
        "n_jobs": int(snap.num_jobs),
        "loops": int(single["num_loops"]),
        "loop_stats": [w["loop_stats"] if w else None for w in res["workers"]],
        "scheduled": int(np.asarray(single["scheduled_mask"]).sum()),
        "preempted": int(np.asarray(single["preempted_mask"]).sum()),
        "spot_price": float(single["spot_price"]),
        "single_solve_s": single_s,
        "rank_solve_s": [w["solve_s"] if w else None for w in res["workers"]],
    }
    if args.ring_calls:
        report["ring"] = [w.get("ring") if w else None for w in res["workers"]]
    return report


if __name__ == "__main__":
    sys.exit(main())
