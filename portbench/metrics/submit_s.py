"""submit: host seconds of each period's SubmitService.submit calls, mean
per cycle (the benchmark's clock)."""


def read(run):
    return sum(r["submit_s"] for r in run.cycles) / len(run.cycles) if run.cycles else None
