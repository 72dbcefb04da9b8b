"""The benchmark of armada_tpu_torch, the PyTorch and CUDA port: Armada's
scheduler service cycle on one card, driven by data.

BENCHMARK.json names the cells; each names a configuration
(`configs/<name>.json`: the pool, its executors, queues, priority
classes and scheduler settings) and a traffic mix (`traffic/<name>.json`:
job sizes, gangs, runtimes, submissions a period, warm-up), which the
one generator (traffic.py) reads. Each per-layer metric is a reader of
its own (`metrics/<name>.py`), each kernel's byte count a module of its
own (`roofline/<kernel>.py`). The plain reference (reference.py) and the
comparison (judge.py) decide `correct`.

Nothing here imports JAX or the JAX package; the port is imported only
where a run drives it.
"""
