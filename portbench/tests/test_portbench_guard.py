"""Nothing the benchmark runs loads JAX or the JAX package.

A fresh interpreter blocks every import whose top-level name is `jax`,
`jaxlib`, `flax` or `armada_tpu` (compared whole: `armada_tpu_torch` is
the port and loads), then imports the harness and drives a run on the
CPU at a tiny size: the generator, the program, the reference and the
judge, and every per-layer reader (the device's readers on a synthetic
trace). It then checks `sys.modules` as the harness does after its
window."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "armada_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, "portbench/tests")
    import logging
    logging.disable(logging.INFO)
    import json, pkgutil
    import portbench, portbench.metrics, portbench.roofline
    from portbench import metrics, run, trace
    from conftest import tiny

    bench, cell, config, mix = tiny("gangs")
    line = run.run_cell(bench, cell, config, mix, seed=4, seconds=0.3, trace=True,
                        t0=0.0, device="cpu", log=lambda m: None)
    assert line["attempted"] >= 1
    # The device's readers on a synthetic trace.
    tr = trace.reduce([("score_nodes_kernel<true>", 10, 20), ("fill_take_kernel<8>", 30, 35)],
                      0, 100, [("cycle", 0, 100)])
    view = run.Run(cycles=[], trace=tr, shape={"nodes": 8, "lanes": 4, "taint_words": 1,
                                               "label_words": 1, "window": 8}, config=config)
    for m in ("score_nodes_roofline", "fill_take_roofline", "device_idle_share"):
        assert metrics.read(m, view) is not None
    for mod in pkgutil.iter_modules(portbench.metrics.__path__):
        __import__(f"portbench.metrics.{mod.name}")
    for mod in pkgutil.iter_modules(portbench.roofline.__path__):
        __import__(f"portbench.roofline.{mod.name}")
    assert run.forbidden_modules() == [], run.forbidden_modules()
    print("ok")
""")


def test_no_jax_in_a_run():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-4000:]


def test_forbidden_names_are_whole():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["armada_tpu_torch", "armada_tpu_torch.solver", "jaxtyping"]) == []
    assert forbidden_modules(["armada_tpu.solver.kernel", "jax._src", "flax", "numpy"]) == [
        "armada_tpu", "flax", "jax"]
