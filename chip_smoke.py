"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives armada_tpu_torch's main path, one scheduling round as the
scheduler runs it (build_round_snapshot -> prep_device_round ->
pad_device_round -> solve_round -> validate_round), on the card, and holds
every hand-written CUDA kernel of that path against its plain torch
version. Phases, each printing one JSON line with its seconds:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: the nvcc build of armada_tpu_torch/csrc/ (one nvcc per source,
   started together).
3. kernels: each kernel against its plain version on the card at the main
   path's shapes (score_nodes at N = 8192 and 65536, all outputs
   bit-equal; fill_take at N = 8192 and 65536 with B = 512 and 2048, with
   duplicate keys, a sentinel tail and a B > N case, index-equal).
4. round: 100,000 queued jobs x 5,000 nodes x 10 queues plus 5,000 running
   preemptible jobs in one queue, in the default configuration (batch
   fill window 512, fast fill off), on the "cuda" and the "lax" kernel
   paths: every output array, num_loops and spot_price bit-equal; the
   round firewall admits it; both kernels launched.
5. flagship: 1,000,000 jobs x 50,000 nodes x 10 queues plus the same
   running jobs, on the "cuda" path: admitted, both kernels launched.

Then one {"kernels": [...]} line (launch counts from the flagship run and
from the 100k round; times at the flagship's shapes: `ms` per call from
CUDA events, `device_ms` per launch from the profiler), the card's name and power limit, and as the last
line {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SCALAR_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, kernel):
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains `kernel`, from torch.profiler over `iters` calls of fn()."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name
    ]
    if len(us) != iters:
        raise AssertionError(f"profiler saw {len(us)} launches of {kernel}, expected {iters}")
    return sum(us) / len(us) / 1e3


def score_case(n, seed):
    """Inputs of score_nodes at N nodes (bench widths: R = 4, one taint and
    one label word, 8 excluded-node slots, an affinity row), on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r = 4
    dev = torch.device("cuda")

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    total = np.tile(np.array([32000, 262144, 0, 0], np.int32), (n, 1))
    alloc0 = total - rng.integers(-4000, 33000, size=(n, r)).astype(np.int32)
    alloc0[:, 2:] = 0
    words = lambda k: rng.integers(-(2**31), 2**31, size=k, dtype=np.int64).astype(np.int32)  # noqa: E731
    args = dict(
        alloc0=t(alloc0),
        node_total=t(total),
        taints=t(np.where(rng.random((n, 1)) < 0.2, words((n, 1)), 0).astype(np.int32)),
        labels=t(words((n, 1))),
        rank=t(rng.permutation(n).astype(np.int32)),
        gid=t(np.arange(n, dtype=np.int32)),
        unsched=t(rng.random(n) < 0.05),
        aff_row=t(words((n + 31) // 32)),
        tolerated=t(words(1)),
        selector=t((words(1) & 0x0101).astype(np.int32)),
        req_fit=t(np.array([2000, 4096, 0, 0], np.int32)),
        excl=t(np.array([3, 17, -1, -1, -1, -1, -1, -1], np.int32)),
        order_res_idx=t(np.array([0, 1], np.int32)),
        order_res_resolution=t(np.array([1, 1], np.int32)),
    )
    rank_bits = max(1, (n - 1).bit_length())
    bits = (16, 19, rank_bits)
    if sum(bits) > 62:
        bits = (15, 16, rank_bits)
    args["bits"] = t(np.array(bits, np.int32))
    args["batch_window"] = 512
    args["job_ok"] = True
    return args


def score_bytes(a):
    n, r = a["alloc0"].shape
    read = sum(
        v.numel() * v.element_size() for v in a.values() if hasattr(v, "numel")
    )
    return read + n * (1 + 4 + 8), n * (10 * r + 40)


def take_case(n, b, seed, kind):
    """Packed-key inputs of fill_take: distinct keys, duplicates, or a
    sentinel tail (fewer than B real keys)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sentinel = np.iinfo(np.int64).max
    if kind == "dups":
        key = rng.integers(0, max(2, n // 64), size=n).astype(np.int64) << 20
    else:
        key = rng.integers(0, 2**60, size=n, dtype=np.int64)
    if kind == "tail":
        key[rng.permutation(n)[: n - b // 3]] = sentinel
    else:
        key[rng.random(n) < 0.3] = sentinel
    return torch.as_tensor(key, device="cuda"), b


def phase_kernels():
    import torch

    from armada_tpu_torch.ops import kernels as K

    checks = []
    timing = {}
    for n in (8192, 65536):
        a = score_case(n, n)
        got = K.score_nodes(**a)
        want = K.score_nodes_plain(**a)
        torch.cuda.synchronize()
        errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want)]
        equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        checks.append({"name": "score_nodes", "n": n, "equal": equal, "max_abs_err": max(errs)})
        if not equal:
            raise AssertionError(f"score_nodes disagrees with its plain version at N={n}")
        if n == 65536:
            kb, ops = score_bytes(a)
            timing["score_nodes"] = {
                "ms": cuda_ms(lambda: K.score_nodes(**a), 200),
                "device_ms": device_ms(lambda: K.score_nodes(**a), 50, "score_nodes_kernel"),
                "plain_ms": cuda_ms(lambda: K.score_nodes_plain(**a), 20),
                "bound_ms": max(kb / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3,
                "library_ms": None,
                "max_abs_err": max(errs),
                "shape": {"N": n, "R": 4},
            }
    cases = [(n, b, kind) for n in (8192, 65536) for b in (512, 2048) for kind in ("distinct", "dups", "tail")]
    cases.append((300, 512, "distinct"))  # B > N
    for n, b, kind in cases:
        key, b = take_case(n, b, n + b, kind)
        take, tkey = K.fill_take(key, b)
        ptake, pkey = K.fill_take_plain(key, b)
        torch.cuda.synchronize()
        equal = bool(torch.equal(take, ptake)) and bool(torch.equal(tkey, pkey))
        err = int((take.to(torch.int64) - ptake.to(torch.int64)).abs().max())
        checks.append({"name": "fill_take", "n": n, "b": b, "keys": kind, "equal": equal, "max_abs_err": err})
        if not equal:
            raise AssertionError(f"fill_take disagrees with its plain version at N={n}, B={b}, {kind}")
        if (n, b, kind) == (65536, 512, "distinct"):
            want = min(b, n)
            timing["fill_take"] = {
                "ms": cuda_ms(lambda: K.fill_take(key, b), 200),
                "device_ms": device_ms(lambda: K.fill_take(key, b), 50, "fill_take_kernel"),
                "plain_ms": cuda_ms(lambda: K.fill_take_plain(key, b), 50),
                "bound_ms": (n * 8 + want * 12) / HBM_BYTES_PER_S * 1e3,
                "library_ms": cuda_ms(lambda: torch.sort(key, stable=True), 50),
                "max_abs_err": err,
                "shape": {"N": n, "B": b},
            }
    return checks, timing


def run_round(n_jobs, n_nodes, paths, warm):
    """Host prep once, then one solve per kernel path (plus a warm repeat
    of the first); returns timings, outputs and launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from armada_tpu_torch.ops import kernels as K
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver import kernel as kernel_mod
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.validate import validate_round

    from armada_tpu_torch.workload import N_RUNNING, build_inputs

    t0 = time.time()
    inputs = build_inputs(n_jobs, n_nodes)
    specs_s = time.time() - t0
    t0 = time.time()
    snap = build_round_snapshot(*inputs)
    dev = pad_device_round(prep_device_round(snap))
    prep_s = time.time() - t0
    res = {
        "jobs": n_jobs, "nodes": n_nodes, "running": N_RUNNING,
        "padded": {"J": int(dev.job_req.shape[0]), "N": int(dev.node_total.shape[0]),
                   "S": int(dev.slot_members.shape[0])},
        "specs_s": specs_s, "host_prep_s": prep_s,
    }
    outs = {}
    for i, path in enumerate(paths):
        d = dataclasses.replace(dev, kernel_path=path)
        reps = 2 if (i == 0 and warm) else 1
        for rep in range(reps):
            K.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            stats = {}
            out = kernel_mod.solve_round(d, readback_rows=snap.num_jobs, stats=stats)
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = dict(K.LAUNCHES)
            label = f"{path}_{'cold' if rep == 0 else 'warm'}"
            res[f"{label}_solve_s"] = dt
            res[f"{label}_launches"] = launches
        res[f"{path}_loops"] = int(out["num_loops"])
        res[f"{path}_loop_kinds"] = stats
        res[f"{path}_scheduled"] = int(np.asarray(out["scheduled_mask"]).sum())
        res[f"{path}_preempted"] = int(np.asarray(out["preempted_mask"]).sum())
        t0 = time.time()
        violation = validate_round(out, dev=d)
        res[f"{path}_validate_s"] = time.time() - t0
        if violation is not None:
            raise AssertionError(f"validate_round rejected the {path} round: {violation}")
        if path == "cuda":
            for name, count in res["cuda_cold_launches"].items():
                if count <= 0:
                    raise AssertionError(f"kernel {name} was not launched on the cuda path")
        outs[path] = out
    return res, outs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from armada_tpu_torch.device import resolve_device
    from armada_tpu_torch.ops import kernels as K

    resolve_device()
    t0 = time.time()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.time() - t0})

    t0 = time.time()
    libs = K.build_all()
    emit({"phase": "build", "libraries": libs, "seconds": time.time() - t0})

    t0 = time.time()
    checks, timing = phase_kernels()
    emit({"phase": "kernels", "checks": checks, "timing": timing, "seconds": time.time() - t0})

    t0 = time.time()
    res, outs = run_round(100_000, 5000, ("cuda", "lax"), warm=True)
    a, b = outs["cuda"], outs["lax"]
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            raise AssertionError(f"round: cuda and lax paths differ on {key}")
    res["cuda_equals_lax"] = True
    emit({"phase": "round", **res, "seconds": time.time() - t0})

    t0 = time.time()
    flag, _ = run_round(1_000_000, 50_000, ("cuda",), warm=False)
    emit({"phase": "flagship", **flag, "seconds": time.time() - t0})

    launches = flag["cuda_cold_launches"]
    replaces = {
        "score_nodes": "armada_tpu/ops/pallas_kernels.py:225 (_score_kernel; body _score_values :156, pallas_call :344)",
        "fill_take": "armada_tpu/ops/pallas_kernels.py:378 (fill_take)",
    }
    entries = []
    for name in K.KERNELS:
        tm = timing[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"armada_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": int(launches[name]),
            "launches_round_100k": int(res["cuda_cold_launches"][name]),
            "max_abs_err": tm["max_abs_err"],
            "equal": tm["max_abs_err"] == 0,
            "ms": tm["ms"],
            "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": "bytes",
            "library_ms": tm["library_ms"],
            "shape": tm["shape"],
        })
    emit({"kernels": entries})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
