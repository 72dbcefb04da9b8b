"""fake cluster: host seconds of the executors' ticks (heartbeats, lease
pickup, completions), mean per cycle (the benchmark's clock)."""


def read(run):
    return sum(r["tick_s"] for r in run.cycles) / len(run.cycles) if run.cycles else None
