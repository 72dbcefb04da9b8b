"""resident sync: `last_cycle_stats["sync_s"]` (the O(J) prep, the diff and
the upload to the resident round), mean per cycle; None where a cycle
ran without a resident round."""

from . import mean_stat


def read(run):
    if any(r["stats"].get("sync") is None for r in run.cycles):
        return None
    return mean_stat(run, "sync_s")
