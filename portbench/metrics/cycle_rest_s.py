"""service cycle: a cycle's wall seconds outside its snapshot, solve and
post-round parts (ingest, reconciliation, publish), mean per cycle."""


def read(run):
    if not run.cycles:
        return None
    rest = []
    for r in run.cycles:
        st = r["stats"]
        parts = [st.get(k) for k in ("snapshot_s", "solve_s", "post_round_s")]
        if any(p is None for p in parts):
            return None
        rest.append(r["cycle_s"] - sum(parts))
    return sum(rest) / len(rest)
