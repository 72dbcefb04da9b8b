"""The device trace of a `--trace 1` window, reduced to what the readers
need.

torch.profiler records the card's activity (kernels, copies, memsets)
over the whole window; the host's clock is not in it. The reduction
keeps, per device operation name, its launches and device seconds, and
the union of all device intervals inside the window (`busy_s`: time in
which something ran on the card). Idle gaps are the window's stretches
between merged intervals, named by what the benchmark's loop was doing
at their middle (the period's submissions, the executors' ticks, the
scheduler's cycle): the profiler stamps device intervals on the same
clock as `time.time_ns()`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PHASES = ("submit", "executor_tick", "cycle")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: dict  # name -> [launches, device seconds]
    idle_by_phase: dict  # phase -> idle seconds
    longest_gaps: list  # [(phase, seconds)], longest first
    events: int

    def kernel(self, part: str) -> tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        `part`."""
        n, s = 0, 0.0
        for name, (k, sec) in self.ops.items():
            if part in name:
                n, s = n + k, s + sec
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = [[f"idle in {p}", s] for p, s in sorted(self.idle_by_phase.items(), key=lambda kv: -kv[1])]
        gaps += [[f"longest gap in {p}", s] for p, s in self.longest_gaps][: 10 - len(gaps)]
        return {"device_ops": [[name[:120], sec] for name, (_, sec) in top], "idle_gaps": gaps}


def device_intervals(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device-side activity."""
    import torch

    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def reduce(intervals, w0_ns: int, w1_ns: int, phases) -> Trace:
    """`phases`: [(phase, start ns, end ns)] of the loop's parts."""
    ops: dict = {}
    spans = []
    for name, a, b in intervals:
        a, b = max(a, w0_ns), min(b, w1_ns)
        if b <= a:
            continue
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (b - a) / 1e9
        spans.append((a, b))
    spans.sort()
    busy, gaps = 0, []
    cur_a = cur_b = None
    edge = w0_ns
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                edge = cur_b
            if a > edge:
                gaps.append((edge, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        edge = cur_b
    if w1_ns > edge:
        gaps.append((edge, w1_ns))
    starts = np.array([p[1] for p in phases], dtype=np.int64)
    idle_by_phase: dict = {}
    labelled = []
    for a, b in gaps:
        mid = (a + b) // 2
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        phase = phases[i][0] if i >= 0 and mid < phases[i][2] else "between"
        idle_by_phase[phase] = idle_by_phase.get(phase, 0.0) + (b - a) / 1e9
        labelled.append((phase, (b - a) / 1e9))
    labelled.sort(key=lambda g: -g[1])
    return Trace(
        window_s=(w1_ns - w0_ns) / 1e9, busy_s=busy / 1e9, ops=ops,
        idle_by_phase=idle_by_phase, longest_gaps=labelled[:10], events=len(spans),
    )


def loop_phases(records) -> list[tuple[str, int, int]]:
    """The loop's parts, from each step's `time.time_ns` bounds."""
    out = []
    for rec in records:
        t0, t1, t2, t3 = rec["ns"]
        out += [(PHASES[0], t0, t1), (PHASES[1], t1, t2), (PHASES[2], t2, t3)]
    return out
