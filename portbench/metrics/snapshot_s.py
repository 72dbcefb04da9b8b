"""snapshot: `last_cycle_stats["snapshot_s"]` (the incremental deltas and
the round snapshot), mean per cycle."""

from . import mean_stat


def read(run):
    return mean_stat(run, "snapshot_s")
