"""Where the time of one round goes on the card.

    python -m armada_tpu_torch.profile_round [--jobs 100000] [--nodes 5000]
        [--running 5000] [--path cuda] [--fast-fill] [--window 512]
        [--hot-window 4096] [--budget 5.0]

Builds the bench's round (workload.build_inputs; `--fast-fill` and
`--window` set its fill configuration), solves it once to load
the kernels, then solves it again under torch.profiler (CUDA activity
only) and prints one JSON line: the solve's wall seconds, the device's
busy seconds (the sum of its kernel and copy intervals, one stream) and
idle share, the loop counts and host seconds by loop kind, and the ten
device operations with the most time. `--hot-window W` solves the round
through the host-driven driver with hot-window compaction at W slots
(above the scheduler's default floor of 524,288 padded slots, which the
1M-job round clears), `--budget S` with a round budget of S seconds; either adds
the solve's profile (its parts' seconds, rewindows, transfer ledger) and
`truncated` to the line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from .snapshot.round import build_round_snapshot
from .solver import kernel as kernel_mod
from .solver.kernel_prep import pad_device_round, prep_device_round
from .workload import build_inputs


def _device_events(prof):
    """(name, microseconds) of every device-side interval in the trace."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.elapsed_us()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=100_000)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--running", type=int, default=5000)
    ap.add_argument("--path", choices=("cuda", "lax"), default="cuda")
    ap.add_argument("--fast-fill", action="store_true", help="merged multi-queue fill")
    ap.add_argument("--window", type=int, default=512, help="batch fill window")
    ap.add_argument("--hot-window", type=int, default=0, metavar="W",
                    help="hot-window compaction at W slots per queue (0: off)")
    ap.add_argument("--budget", type=float, default=None, metavar="S",
                    help="round budget in seconds (maxSchedulingDuration)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA card")

    snap = build_round_snapshot(*build_inputs(
        args.jobs, args.nodes, n_running=args.running, fast_fill=args.fast_fill,
        fill_window=args.window,
    ))
    dev = dataclasses.replace(
        pad_device_round(prep_device_round(snap)), kernel_path=args.path
    )
    driver = {}
    if args.hot_window:
        driver["window"] = args.hot_window
    if args.budget:
        driver["budget_s"] = args.budget
    kernel_mod.solve_round(dev, **driver)  # loads the kernels
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = {}
        out = kernel_mod.solve_round(dev, stats=stats, **driver)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy_us = sum(us for _, us in events)
    by_name: dict = {}
    for name, us in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "card": smi,
        "jobs": args.jobs, "nodes": args.nodes, "running": args.running,
        "path": args.path,
        "fast_fill": args.fast_fill,
        "window": args.window,
        "hot_window": args.hot_window,
        "budget_s": args.budget,
        "truncated": out.get("truncated"),
        "profile": out.get("profile"),
        "num_loops": int(out["num_loops"]),
        "solve_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_intervals": len(events),
        "loops": stats,
        "top_device_ops": [
            {"name": k[:80], "count": n, "s": t / 1e6} for k, (n, t) in top
        ],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
