"""The port's benchmark: one cell, one seed, one process.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json, its configuration from
`portbench/configs/<name>.json` and its traffic mix from
`portbench/traffic/<name>.json`, builds the backlog from the seed, sets
up (the backlog submitted and ingested, the cold cycle, the warm-up
cycles), then runs schedule periods back to back for `--seconds`: the
window ends with the last whole period that starts before the time is
up. With `--trace 1` the window runs under torch.profiler and the line
carries the per-layer metrics instead of the end-to-end ones.

After the window every cycle the run made is held to the plain
reference (judge.py); each number compared is printed beside its limit
as the last lines on standard error and under "checks", last in the
result's line, the last line on standard output.

Needs a CUDA card; exits with 2 and prints no result without one, where
the port is missing, and where the process has loaded JAX or the JAX
package by the time the run is judged.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

from .judge import CONTROLS

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "armada_tpu")


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (the kernel's record of its
    start), or since `fallback_t0` on the monotonic clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - fallback_t0


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or `names`) whose top-level name is JAX's or the
    JAX package's, compared whole (`armada_tpu_torch` is not
    `armada_tpu`)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def load_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic file) of the cell `name`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, mix


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of `cell` reports: its end-to-end
    metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(name: str, run) -> float:
    leased = sum(len(d["leases"]) for d in run.decoded[run.first:])
    if name == "leases_per_s":
        return leased / run.window_s
    if name == "setup_s":
        return run.setup_s
    if name.startswith("cycle_p") and name.endswith("_s"):
        return percentile([r["cycle_s"] for r in run.cycles], float(name[7:-2]))
    raise ValueError(f"no end-to-end metric {name!r}")


class Run:
    """What the readers see of one run (metrics/__init__.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def run_cell(bench, cell, config, mix, *, seed, seconds, trace, t0, device=None,
             controls=(), log=print) -> dict:
    """One run of `cell`; returns the result's line as a dict. `device`
    None is the card; the tests pass "cpu". Each of `controls`
    (judge.CONTROLS) is judged in the program's place on the same run,
    its verdict under "controls"."""
    import torch

    from . import metrics as metric_readers
    from .judge import judge
    from .roofline import round_shape
    from .service import Pool
    from .trace import device_intervals, loop_phases, reduce

    on_card = device is None
    pool = Pool(config, mix, seed, device=device)
    parts = pool.start()
    cold = pool.step(0)
    warm = min(int(mix["warm_cycles"]), int(config["max_warm_cycles"]))
    for k in range(1, warm + 1):
        pool.step(k)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s(t0)
    log(f"setup {setup_s:.3f} s: build {parts['build_s']:.3f}, submit {parts['submit_s']:.3f}, "
        f"ingest {parts['ingest_s']:.3f}, cold cycle {cold['cycle_s']:.3f}, {warm} warm cycles")

    prof = None
    if trace and on_card:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    first = len(pool.records)
    w0_ns, w0 = time.time_ns(), time.perf_counter()
    k = first
    while time.perf_counter() - w0 < seconds:
        pool.step(k)
        k += 1
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - w0
    w1_ns = w0_ns + int(window_s * 1e9)
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    cycles = pool.records[first:]
    decoded = pool.decode()
    pool.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    priority = int(config["priority_classes"][mix["priority_class"]]["priority"])
    t = time.perf_counter()
    verdict = judge(pool.traffic, pool.nodes, decoded, priority)
    log(f"judged {len(decoded)} cycles in {time.perf_counter() - t:.3f} s; "
        f"faults: {verdict['notes'] or 'none'}")
    judged = {}
    for name in controls:
        judged[name] = judge(pool.traffic, pool.nodes, decoded, priority, control=name)["checks"]
        judged[name] = {"correct": all(c["value"] <= c["limit"] for c in judged[name].values()),
                        "checks": judged[name]}
        log(f"control {name}: correct {judged[name]['correct']}")
    if cycles:
        steps = [r["submit_s"] + r["tick_s"] + r["cycle_s"] for r in cycles]
        mean = lambda f: sum(f(r) for r in cycles) / len(cycles)  # noqa: E731
        resets = sum((r["stats"].get("sync") or {}).get("mode") == "reset" for r in cycles)
        log(f"window {window_s:.3f} s: {len(cycles)} cycles, step mean "
            f"{sum(steps) / len(steps):.4f} s (submit {mean(lambda r: r['submit_s']):.4f}, "
            f"tick {mean(lambda r: r['tick_s']):.4f}, cycle {mean(lambda r: r['cycle_s']):.4f}); "
            f"collector {sum(r['gc_s'] for r in cycles):.3f} s, "
            f"{sum(r['gc_full'] for r in cycles)} full; {resets} reset syncs")
        log("window steps (submit tick cycle collector): " + " ".join(
            f"{r['submit_s']:.3f}/{r['tick_s']:.3f}/{r['cycle_s']:.3f}/{r['gc_s']:.3f}"
            for r in cycles))

    tr = None
    if prof is not None:
        t = time.perf_counter()
        tr = reduce(device_intervals(prof), w0_ns, w1_ns, loop_phases(cycles))
        log(f"trace: {tr.events} device intervals reduced in {time.perf_counter() - t:.3f} s")
        del prof

    run = Run(cycles=cycles, decoded=decoded, first=first, window_s=window_s,
              setup_s=setup_s, trace=tr, shape=round_shape(config), config=config)
    out = {}
    for m in cell_metrics(bench, cell["name"], bool(trace)):
        v = (metric_readers.read(m["name"], run) if trace
             else end_to_end(m["name"], run))
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = [c for c in verdict["bad_cycles"] if c >= first]
    checks = verdict["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    line = {"correct": correct, "attempted": len(cycles), "failed": len(bad),
            "metrics": out, "device": dev}
    if tr is not None:
        line["breakdown"] = tr.breakdown()
    if judged:
        line["controls"] = judged
    line["checks"] = checks
    return line


def main(argv=None, t0=None) -> int:
    t0 = time.monotonic() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, action="append", default=[],
                    help="also judge this control in the program's place: fifo breaks queue "
                         "fairness, firstfit best fit (the check's control; not a benchmark run)")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed: a whole number >= 0")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, mix = load_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # Kernel caches live at fixed paths inside the checkout (the port's
    # own nvcc builds go to build/kernels/ beside them).
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    try:
        import armada_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is missing ({e})", file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    log(f"{args.workload} seed {args.seed}: {smi()}")
    line = run_cell(bench, cell, config, mix, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), t0=t0, controls=tuple(args.control), log=log)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the port's run must not", file=sys.stderr)
        return 2
    for control, v in line.get("controls", {}).items():
        for name, c in v["checks"].items():
            print(f"control {control} check {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
