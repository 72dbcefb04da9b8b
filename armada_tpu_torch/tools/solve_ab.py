"""Solve times of the bench rounds on one card, to compare two trees of the
port within one call (parent, change, change, parent):

    python3 armada_tpu_torch/tools/solve_ab.py --root DIR [--cell flagship_1m] [--repeat 2]
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --kernels
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --ring 50

Imports `armada_tpu_torch` from DIR, a checkout of the repository (this one,
or another unpacked beside it with `git archive`), and builds its kernels
there. Per cell it builds the round once, then solves it on the "cuda"
path once cold and `--repeat` times warm, and prints one JSON line: the
tree, the card's name and power limit, each solve's seconds, the loop
counts and host seconds by kind (`fill_s`, `gang_s`) and the kernels'
launches. Cells are chip_smoke.py's rounds, from
`armada_tpu_torch.workload.build_inputs`: round_100k (100,000 jobs x
5,000 nodes) and flagship_1m (1,000,000 x 50,000) on one device, the
same two with fast fill on (round_100k_fast at a window of 512,
flagship_fast at the bench's 2,048; loop counts and host seconds by kind
include `merged_fill_loops` and `merged_fill_s`), flagship_window
(flagship_1m through the host-driven driver at the scheduler's default
hot window of 4,096 slots, compacted; its solves add the driver's
`profile`: parts' seconds, rewindows, transfer ledger), and
gangs_100k_2x2 (100,000 queued jobs x 5,000 nodes, every 8th job opening a
gang, no running jobs) node-sharded over a 2x2 mesh of four shard threads
on the card, whose gangs select nodes through the winner kernel (its
loop counts and host seconds are shard 0's, its launches all shards').
With `--kernels` it first times the tree's kernels on DIR's own
chip_smoke.py inputs: the two fill-loop kernels at N = 65,536 (B = 512),
score_nodes also through the round's plan where the tree has one, and
winner_reduce on the 2x2 round's rows (P = 2, K = 3): each wrapper's ms
per call (CUDA events) and each kernel's device ms per launch
(torch.profiler). With `--ring CALLS` it drives the tree's ring kernel
on this one card over gloo, in two and then four worker processes
(`parallel.launcher.launch` with no round, n = 2 and 4 members on the chip
axis), CALLS calls per case, and prints per n each member's ms per call
(CUDA events), device ms, the plain version's ms and that of a gather plus
winner_reduce, and the calls that disagreed with the plain version. Then
the cells named by `--cell`, none by default with `--kernels` or
`--ring`. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import time

CELLS = {
    "round_100k": (100_000, 5000, {}),
    "flagship_1m": (1_000_000, 50_000, {}),
    "gangs_100k_2x2": (100_000, 5000, {"n_running": 0, "gang_every": 8}),
    # Fast fill: at the scheduler's window of 512, and in the bench's own
    # configuration, a window of 2,048.
    "round_100k_fast": (100_000, 5000, {"fast_fill": True, "fill_window": 512}),
    "flagship_fast": (1_000_000, 50_000, {"fast_fill": True, "fill_window": 2048}),
    # The flagship as the scheduler solves it: the hot window at its
    # default 4,096 slots per queue (compacted above the default floor of
    # 524,288 slots), against flagship_1m, the same round fused.
    "flagship_window": (1_000_000, 50_000, {}),
}
# solve_round's keywords per cell: the host-driven driver's.
DRIVER = {"flagship_window": {"window": 4096}}
SHARDED = {"gangs_100k_2x2": "2x2"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose armada_tpu_torch to import")
    ap.add_argument("--cell", action="append", choices=sorted(CELLS),
                    help="default: all, or none with --kernels or --ring")
    ap.add_argument("--repeat", type=int, default=2, help="warm solves after the cold one")
    ap.add_argument("--kernels", action="store_true", help="time the kernels first")
    ap.add_argument("--ring", type=int, default=0, metavar="CALLS",
                    help="drive the ring kernel at n = 2 and 4 on this card first")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("solve_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import armada_tpu_torch
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.workload import build_inputs

    if not os.path.abspath(armada_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"solve_ab: imported armada_tpu_torch from {armada_tpu_torch.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.time()
    K.build_all()
    build_s = time.time() - t0
    if args.kernels:
        print(json.dumps({"tree": root, "card": smi, "kernels": kernel_times(K)}), flush=True)
    for n in (2, 4) if args.ring else ():
        print(json.dumps({"tree": root, "card": smi, "ring": ring_times(n, args.ring)}), flush=True)
    for cell in args.cell or ([] if args.kernels or args.ring else sorted(CELLS)):
        n_jobs, n_nodes, kw = CELLS[cell]
        snap = build_round_snapshot(*build_inputs(n_jobs, n_nodes, **kw))
        dev = dataclasses.replace(pad_device_round(prep_device_round(snap)), kernel_path="cuda")
        solve = functools.partial(solve_round, dev)
        if cell in SHARDED:
            from armada_tpu_torch.parallel.mesh import pad_nodes
            from armada_tpu_torch.parallel.multihost import resolve_solver

            count = torch.cuda.device_count()
            run = resolve_solver(SHARDED[cell], "cuda", devices=[f"cuda:{k % count}" for k in range(4)])
            solve = functools.partial(run, pad_nodes(dev, run.n_shards))
        solves = []
        for rep in range(1 + args.repeat):
            stats = {}
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            if cell in SHARDED:
                solve(readback_rows=snap.num_jobs)
                for k in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(k)
                stats = {**run.loop_stats, "selects": run.last_stats.selects}
            else:
                out = solve(readback_rows=snap.num_jobs, stats=stats, **DRIVER.get(cell, {}))
                torch.cuda.synchronize()
                if "profile" in out:
                    stats["profile"] = out["profile"]
            solves.append({"cold": rep == 0, "solve_s": time.time() - t0, **stats,
                           "launches": dict(K.LAUNCHES)})
        print(json.dumps({"tree": root, "cell": cell, "card": smi, "build_s": build_s,
                          "solves": solves}), flush=True)
    return 0


def ring_times(n, calls) -> dict:
    """The ring drive of the tree's launcher in n gloo processes on card
    0; raises with the workers' last output when the launch failed."""
    from armada_tpu_torch.parallel.launcher import launch

    res = launch(None, 1, n, devices=["cuda:0"] * n, backend="gloo", timeout_s=300.0,
                 ring_calls=calls)
    if not res["ok"]:
        raise SystemExit(f"solve_ab: ring launch at n = {n} failed:\n" + "\n".join(
            t[-2000:] for t in res.get("tails", [])))
    members = [w["ring"]["chips"] for w in res["workers"]]
    keys = ("ms", "device_ms", "plain_ms", "gather_reduce_ms")
    return {"n": n, "calls": calls, "mismatches": sum(m["mismatches"] for m in members),
            **{k: [m[k] for m in members] for k in keys}}


def kernel_times(K) -> dict:
    """The fill-loop kernels at N = 65,536 on the tree's chip_smoke.py
    inputs (score_case, and take_case's distinct keys with B = 512)."""
    import chip_smoke as S
    from armada_tpu_torch.timing import cuda_ms, device_ms

    a = S.score_case(65536, 65537)
    key, b = S.take_case(65536, 512, 65536 + 512, "distinct")
    fns = {"score_nodes": lambda: K.score_nodes(**a)}
    if hasattr(K, "ScorePlan"):
        plan = S.plan_case(a)
        fns["score_plan"] = lambda: plan.score(a["alloc0"], 3)
    out = {name: {"ms": cuda_ms(fn, 500)} for name, fn in fns.items()}
    dev = device_ms(fns, 200, "score_nodes_kernel")
    for name in fns:
        out[name]["device_ms"] = dev[name]
    out["fill_take"] = {
        "ms": cuda_ms(lambda: K.fill_take(key, b), 500),
        "device_ms": device_ms({"f": lambda: K.fill_take(key, b)}, 200, "fill_take_kernel")["f"],
    }
    import numpy as np

    rows = K.winner_rows(*S.winner_case(np.random.default_rng(2), 2, 3, 0.5))
    fns = {"row": lambda: K.winner_reduce_rows(rows)}
    if "pick" in inspect.signature(K.winner_reduce_rows).parameters:
        # The host stage's call: the row and the select's (gid, found).
        fns["pick"] = lambda: K.winner_reduce_rows(rows, pick=True)
    dev = device_ms(fns, 200, "winner_reduce")
    out["winner_reduce"] = {
        label: {"ms": cuda_ms(fn, 500), "device_ms": dev[label]} for label, fn in fns.items()
    }
    return out


if __name__ == "__main__":
    sys.exit(main())
