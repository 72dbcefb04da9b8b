"""Solve times of the bench rounds on one card, to compare two trees of the
port within one call (parent, change, change, parent):

    python3 armada_tpu_torch/tools/solve_ab.py --root DIR [--cell flagship_1m] [--repeat 2]
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --kernels
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --ring 50
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --segment --cell gangs_100k
    python3 armada_tpu_torch/tools/solve_ab.py --root DIR --cell round_100k_fast --census

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
gangs_100k (100,000 queued jobs x 5,000 nodes, every 8th job opening a
gang, no running jobs) on one device, and gangs_100k_2x2, the same round
node-sharded over a 2x2 mesh of four shard threads on the card, whose
gangs select nodes through the winner kernel (its loop counts and host
seconds are shard 0's, its launches all shards').
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
`--ring`. With `--segment` it first times the tree's integer scatter-add as the "cuda"
path calls it (`ops.segment.segment_sum`, or `index_add_int` for an add
onto an allocation) at SEGMENT_CASES, chip_smoke.py's cases, in int32
and int64: per case the ms per call (CUDA events), the device ms per
call (torch.profiler, every kernel, memset and copy of the call summed)
and the segment kernel's own (`kernel_device_ms`);
on a tree whose `ops.kernels` has `segment_plan`, also under each
strategy that accepts the case. With `--census`, each one-device cell
is solved once more with the tree's segment wrappers recorded: per call
shape the calls, the share of nonzero values and how ordered the index
is, and each accepted strategy timed on that shape's first inputs.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import math
import os
import subprocess
import sys
import time

CELLS = {
    "round_100k": (100_000, 5000, {}),
    "flagship_1m": (1_000_000, 50_000, {}),
    "gangs_100k": (100_000, 5000, {"n_running": 0, "gang_every": 8}),
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
# The round's integer sums (chip_smoke.py's segment cases): name -> (x
# shape, dim, index length, "sum" into zeros or "add" onto x, index
# order). The fill loop's per-queue count (20,480 taken slots into 16
# queues), random and sorted by queue as the merged fill passes them; a
# gang bind's one node column of a [3, 8,192, 4] allocation; a fill's
# rows into 8,192 nodes; the setup's 131,072 job rows of 4 lanes into
# 8,192 nodes (the eviction sums' shape) and into Q x C = 64 queue
# classes, random and sorted by class as the round passes `qseg`; every
# row into one segment; and the flagship's 1,048,576 rows into 65,536
# nodes.
SEGMENT_CASES = {
    "queue_counts": ((16,), 0, 20480, "sum", "random"),
    "queue_counts_sorted": ((16,), 0, 20480, "sum", "sorted"),
    "bind_column": ((3, 8192, 4), 1, 1, "add", "random"),
    "fill_rows": ((8192, 4), 0, 2048, "sum", "random"),
    "rows_to_nodes": ((8192, 4), 0, 131072, "sum", "random"),
    "rows_to_classes": ((64, 4), 0, 131072, "sum", "random"),
    "rows_to_classes_sorted": ((64, 4), 0, 131072, "sum", "sorted"),
    "rows_to_one": ((1, 4), 0, 131072, "sum", "sorted"),
    "flagship_rows_to_nodes": ((65536, 4), 0, 1048576, "sum", "random"),
}


def segment_inputs(name, dtype, seed, device="cuda"):
    """Seeded (x, dim, index, values) of SEGMENT_CASES[name] on `device`:
    values at the dtype's extremes (the sums wrap), half of them 0; x
    likewise (a "sum" case adds into zeros, and x is its shape's zeros)."""
    import numpy as np
    import torch

    shape, dim, k, form, order = SEGMENT_CASES[name]
    rng = np.random.default_rng(seed)
    np_dtype = np.int32 if dtype == torch.int32 else np.int64
    info = np.iinfo(np_dtype)
    vshape = shape[:dim] + (k,) + shape[dim + 1:]
    values = rng.integers(info.min, info.max, size=vshape, dtype=np.int64).astype(np_dtype)
    values[rng.random(vshape) < 0.5] = 0
    if form == "sum":
        x = np.zeros(shape, np_dtype)
    else:
        x = rng.integers(info.min, info.max, size=shape, dtype=np.int64).astype(np_dtype)
    index = rng.integers(0, shape[dim], size=k)
    if order == "sorted":
        index = np.sort(index)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return dev(x), dim, dev(index), dev(values)


def segment_call(name, fn_add, fn_sum, a, **kw):
    """The case's call as the round makes it: fn_sum(values, index, n) for
    a "sum" case, fn_add(x, dim, index, values) for an "add"."""
    x, dim, index, values = a
    if SEGMENT_CASES[name][3] == "sum":
        return lambda: fn_sum(values, index, x.shape[0], **kw)
    return lambda: fn_add(x, dim, index, values, **kw)


def device_total_ms(fn, iters, match=None):
    """Mean device milliseconds per call of fn(): every CUDA event the
    profiler sees (kernels, memsets, copies), or those whose name holds
    `match`, summed over `iters` calls; None when it saw none."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and (match is None or match in e.name)]
    return sum(us) / iters / 1e3 if us else None


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
    ap.add_argument("--segment", action="store_true",
                    help="time the integer scatter-add first")
    ap.add_argument("--census", action="store_true",
                    help="after a one-device cell's solves, one more with the segment sums recorded")
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
    if args.segment:
        print(json.dumps({"tree": root, "card": smi, "segment": segment_times()}), flush=True)
    for n in (2, 4) if args.ring else ():
        print(json.dumps({"tree": root, "card": smi, "ring": ring_times(n, args.ring)}), flush=True)
    for cell in args.cell or ([] if args.kernels or args.ring or args.segment else sorted(CELLS)):
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
        if args.census and cell not in SHARDED and hasattr(K, "segment_plan"):
            census = segment_census(K, lambda: solve(readback_rows=snap.num_jobs,
                                                     **DRIVER.get(cell, {})))
            print(json.dumps({"tree": root, "cell": cell, "card": smi, "census": census}), flush=True)
    return 0


def segment_census(K, solve) -> dict:
    """One solve() with the tree's segment wrappers wrapped: per call shape
    (outer, n, k, inner, bytes) the calls, the share of nonzero values, and
    the shares of index entries not below and equal to their predecessor;
    then, on that shape's first call's inputs, the strategy segment_plan
    picks and each accepted strategy's ms and device ms a call."""
    import torch

    from armada_tpu_torch.timing import cuda_ms

    seen, wrapped = {}, (K.segment_add, K.segment_sum)

    def record(shape, index, values, call):
        if shape not in seen:
            seen[shape] = {"calls": 0, "values": 0, "nonzero": 0, "pairs": 0, "ordered": 0,
                           "repeats": 0, "call": call}
        rec = seen[shape]
        d = index[1:] - index[:-1]
        rec["calls"] += 1
        rec["values"] += values.numel()
        rec["nonzero"] += int(torch.count_nonzero(values))
        rec["pairs"] += d.numel()
        rec["ordered"] += int((d >= 0).sum())
        rec["repeats"] += int((d == 0).sum())

    def segment_add(x, dim, index, values, plan=None):
        dim = dim % x.dim()
        shape = (math.prod(x.shape[:dim]), x.shape[dim], index.numel(),
                 math.prod(x.shape[dim + 1:]), x.element_size())
        a = (x.clone(), dim, index.clone(), values.clone()) if shape not in seen else None
        record(shape, index.reshape(-1), values, lambda p, a=a: wrapped[0](*a, plan=p))
        return wrapped[0](x, dim, index, values, plan=plan)

    def segment_sum(values, segments, n, plan=None):
        shape = (1, n, segments.numel(), math.prod(values.shape[1:]), values.element_size())
        a = (values.clone(), segments.clone(), n) if shape not in seen else None
        record(shape, segments.reshape(-1), values, lambda p, a=a: wrapped[1](*a, plan=p))
        return wrapped[1](values, segments, n, plan=plan)

    K.segment_add, K.segment_sum = segment_add, segment_sum
    try:
        solve()
        torch.cuda.synchronize()
    finally:
        K.segment_add, K.segment_sum = wrapped
    out = {}
    for shape, rec in seen.items():
        call = rec.pop("call")
        rec["nonzero_share"] = rec["nonzero"] / max(1, rec["values"])
        rec["ordered_share"] = rec["ordered"] / max(1, rec["pairs"])
        rec["repeat_share"] = rec["repeats"] / max(1, rec["pairs"])
        rec["strategy"] = K.segment_plan(*shape).strategy
        rec["by"] = {}
        for strategy in K.segment_strategies(*shape):
            plan = K.segment_plan(*shape, strategy=strategy)
            fn = functools.partial(call, plan)
            rec["by"][strategy] = {"ms": cuda_ms(fn, 200), "device_ms": device_total_ms(fn, 50)}
        out[str(list(shape))] = rec
    return out


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


def segment_times() -> dict:
    """The tree's integer sums at SEGMENT_CASES in int32 and int64 (see
    the module docstring): {case_dtype: {ms, device_ms, [strategy, by]}}."""
    import torch

    from armada_tpu_torch.device import resolve_device
    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.ops.segment import index_add_int, segment_sum
    from armada_tpu_torch.timing import cuda_ms

    resolve_device()
    add = functools.partial(index_add_int, kernel=True)
    add_sum = functools.partial(segment_sum, kernel=True)
    out = {}
    for i, name in enumerate(SEGMENT_CASES):
        for dtype in (torch.int32, torch.int64):
            a = segment_inputs(name, dtype, i)
            call = segment_call(name, add, add_sum, a)
            rec = {"ms": cuda_ms(call, 500), "device_ms": device_total_ms(call, 100),
                   "kernel_device_ms": device_total_ms(call, 100, "segment_")}
            if hasattr(K, "segment_plan"):
                x, dim, index, values = a
                shape = (math.prod(x.shape[:dim]), x.shape[dim], index.numel(),
                         math.prod(x.shape[dim + 1:]), x.element_size())
                rec["strategy"] = K.segment_plan(*shape).strategy
                rec["by"] = {}
                for strategy in K.segment_strategies(*shape):
                    plans = {strategy: K.segment_plan(*shape, strategy=strategy)}
                    if strategy == "shared":
                        # Also at four times and a quarter of the values a
                        # CTA takes (SEGMENT_CTA_VALUES).
                        for cta in (K.SEGMENT_CTA_VALUES // 4, K.SEGMENT_CTA_VALUES * 4):
                            plans[f"shared@{cta}"] = K.SegmentPlan(
                                "shared", -(-values.numel() // cta), plans[strategy].wide)
                    for label, plan in plans.items():
                        fn = segment_call(name, K.segment_add, K.segment_sum, a, plan=plan)
                        rec["by"][label] = {"grid": plan.grid,
                                            "ms": cuda_ms(fn, 500),
                                            "device_ms": device_total_ms(fn, 100),
                                            "kernel_device_ms": device_total_ms(fn, 100, "segment_")}
            out[f"{name}_{str(dtype)[6:]}"] = rec
    return out


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
