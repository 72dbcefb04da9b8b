"""interpreter: seconds the Python interpreter's cyclic garbage collector
ran (gc.callbacks, the benchmark's clock), wherever in the step it
struck, mean per cycle."""


def read(run):
    return sum(r["gc_s"] for r in run.cycles) / len(run.cycles) if run.cycles else None
