"""resident sync: bytes uploaded by the sync (`last_sync["bytes_up"]`),
mean per cycle; None where a cycle ran without a resident round."""


def read(run):
    vals = [(r["stats"].get("sync") or {}).get("bytes_up") for r in run.cycles]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
