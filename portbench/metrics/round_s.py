"""round driver: the solve's seconds less the sync's (`solve_s -
sync_s`: the host-driven round on the card, the firewall, the read-back),
mean per cycle."""

from . import mean_stat


def read(run):
    solve, sync = mean_stat(run, "solve_s"), mean_stat(run, "sync_s")
    return None if solve is None or sync is None else solve - sync
