"""Solve times of the bench rounds on one card, to compare two trees of the
port within one call (parent, change, change, parent):

    python3 armada_tpu_torch/tools/solve_ab.py --root DIR [--cell flagship_1m] [--repeat 2]
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --kernels

Imports `armada_tpu_torch` from DIR, a checkout of the repository (this one,
or another unpacked beside it with `git archive`), and builds its kernels
there. Per cell it builds the round once, then solves it on the "cuda"
path once cold and `--repeat` times warm, and prints one JSON line: the
tree, the card's name and power limit, each solve's seconds, the loop
counts and host seconds by kind (`fill_s`, `gang_s`) and the kernels'
launches. Cells are chip_smoke.py's single-device rounds, from
`armada_tpu_torch.workload.build_inputs`: round_100k (100,000 jobs x
5,000 nodes) and flagship_1m (1,000,000 x 50,000). With `--kernels` it
first times the tree's two fill-loop kernels on DIR's own chip_smoke.py
inputs at N = 65,536 (B = 512): each wrapper's ms per call (CUDA events)
and each kernel's device ms per launch (torch.profiler), score_nodes also
through the round's plan where the tree has one; then the cells named by
`--cell`, none by default. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CELLS = {"round_100k": (100_000, 5000), "flagship_1m": (1_000_000, 50_000)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose armada_tpu_torch to import")
    ap.add_argument("--cell", action="append", choices=sorted(CELLS),
                    help="default: both, or none with --kernels")
    ap.add_argument("--repeat", type=int, default=2, help="warm solves after the cold one")
    ap.add_argument("--kernels", action="store_true", help="time the fill-loop kernels first")
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
    for cell in args.cell or ([] if args.kernels else sorted(CELLS)):
        n_jobs, n_nodes = CELLS[cell]
        snap = build_round_snapshot(*build_inputs(n_jobs, n_nodes))
        dev = dataclasses.replace(pad_device_round(prep_device_round(snap)), kernel_path="cuda")
        solves = []
        for rep in range(1 + args.repeat):
            stats = {}
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            solve_round(dev, readback_rows=snap.num_jobs, stats=stats)
            torch.cuda.synchronize()
            solves.append({"cold": rep == 0, "solve_s": time.time() - t0, **stats,
                           "launches": dict(K.LAUNCHES)})
        print(json.dumps({"tree": root, "cell": cell, "card": smi, "build_s": build_s,
                          "solves": solves}), flush=True)
    return 0


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
    return out


if __name__ == "__main__":
    sys.exit(main())
