"""Per-layer metrics: one reader a metric, `<name>.py` with
`read(run) -> float | None`, found by the metric's name in
BENCHMARK.json. A reader that finds nothing to read returns None, and
the metric is left out of the run's line.

`run` has `cycles` (the window's step records, service.Pool.step),
`trace` (trace.Trace of the window, or None), `shape` (the round's shape,
roofline.round_shape) and `config` (the configuration file).

Means are over all the window's cycles.
"""

from __future__ import annotations

import importlib


def read(name: str, run):
    return importlib.import_module(f"{__name__}.{name}").read(run)


def mean_stat(run, key):
    """Mean over the window's cycles of a `last_cycle_stats` number, or
    None where a cycle lacks it."""
    vals = [rec["stats"].get(key) for rec in run.cycles]
    if not vals or any(v is None for v in vals):
        return None
    return sum(float(v) for v in vals) / len(vals)


def roofline_share(run, module) -> float | None:
    """A kernel's share of its roofline, in %: its launches' least time
    (bytes at the round's shape over peak bandwidth) over their device
    time in the trace."""
    from ..roofline import least_seconds

    if run.trace is None:
        return None
    launches, device_s = run.trace.kernel(module.KERNEL)
    if not launches or device_s <= 0:
        return None
    return 100.0 * launches * least_seconds(module.launch_bytes(run.shape)) / device_s
