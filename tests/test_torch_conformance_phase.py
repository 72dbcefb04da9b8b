"""chip_smoke.py's phase 19 (`phase_conformance`) on the CPU: the Go
table cases and the scale sweep compiled for the port, every round on
"cuda" (the kernels' plain versions here) and "lax" through the twin
assert_parity; BASELINE.md's five configurations on the port's kernel
and oracle backends, histories equal; the quantity parser against the
Fraction path on a 2,000-job workload build. Every check of the phase
holds but the launch counts, which only the card's kernels make; the
1,000-node case runs on the card (and here behind
ARMADA_TPU_BIG_PARITY, tests/test_torch_conformance_tables.py).

The phase runs in a process of its own with jax, jaxlib, armada_tpu and
_armada_native blocked, as on the card's machine, which has no JAX: it
must load none of them (tests/test_torch_guard.py blocks the same names
for the port's modules and the other phases)."""

import json
import os
import subprocess
import sys
import textwrap

import torch_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PHASE = textwrap.dedent(
    """
    import importlib.util, json, sys

    BLOCKED = ("jax", "jaxlib", "armada_tpu", "_armada_native")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    class Block:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT + "/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.require_fill_launches = lambda launches, label: None
    rec = smoke.phase_conformance(device="cpu", thousand=False, parser_jobs=2000)
    loaded = sorted(m for m in sys.modules if blocked(m))
    assert not loaded, loaded
    print("PHASE", json.dumps({"fuzz": smoke.PARSER_FUZZ, "rec": rec}, default=str))
    """
)


def test_phase_conformance_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _PHASE],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("PHASE ")][-1]
    out = json.loads(line[len("PHASE "):])
    rec = out["rec"]
    rounds = rec["rounds"]
    assert rounds["table_cases"] == 27 and rounds["scale_cases"] == 2
    assert len(rounds["cases"]) == 29
    assert all(c["rounds"] > 0 for c in rounds["cases"].values())
    assert rounds["totals"]["scheduled"] > 0 and rounds["totals"]["preempted"] > 0
    assert set(rounds["totals"]["parts_s"]) == {"snapshot", "oracle", "prep", "cuda", "lax"}
    configs = rec["baseline"]["configs"]
    assert len(configs) == 5 and all(c["history_equal"] for c in configs.values())
    assert all(c["kernel"]["cycles"] == c["oracle"]["cycles"] and c["kernel"]["cycles"][0] > 0
               for c in configs.values())
    parser = rec["parser"]
    assert parser["samples"] == 38 * 4 * 2 and parser["fuzz"] == out["fuzz"]
    assert parser["workload_jobs"] == 2000 + 5000 and parser["distinct_specs"] == 4
    assert set(rec["launches"]) == {"score_nodes", "fill_take", "winner_reduce",
                                    "ring_exchange", "segment_add"}
