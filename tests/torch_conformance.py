"""The port's side of the placement conformance cases: the Go table cases
(tests/test_reference_tables.py), the scale sweep
(tests/test_parity_scale.py) and BASELINE.md's configurations
(tests/test_baseline_configs.py), as the port's CPU tests and
chip_smoke.py's phase 19 run them.

`assert_parity` is the port's twin of tests/test_kernel_parity.py's, with
the same signature and return value. On one round it holds:

- the port's `solve_round` on every path of `PARITY.paths` ("lax", and
  "cuda" where asked) bit-equal on every output, num_loops and
  spot_price included;
- the first path against the port's host oracle under the reference's
  checks: assigned_node, scheduled_mask and preempted_mask equal,
  demand_capped_fair_share within a relative 1e-12;
- with `PARITY.reference` set (a deque of the JAX package's rounds in the
  order its own case solved them, `record_reference`), the port's padded
  round equal to the reference's field for field and the port's outputs
  equal to the reference's `solve_round`: the decisions, num_loops and
  spot_price bit for bit, the fair shares within 4 ULP (16 for the
  uncapped accumulator).

`port_module` compiles one of the reference's test files with its
`armada_tpu` imports pointed at the port and its `assert_parity` at this
module's, reading the file itself: it never imports the JAX package, so
the card's machine (no jax) runs the same cases. `canon` is the plain,
comparable form of a snapshot, an oracle result or a resource factory of
either package, over `plain`; `record_cycles` records the leases
(`leases_view`) after every scheduling cycle. tests/torch_control_plane.py
re-exports these three; they live here so that phase 19 records
BASELINE's histories without importing that module, which builds both
packages' control planes at import.

Imports nothing of the JAX package and nothing of the port at module
level; the port is imported where a round is solved.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
import re
import time
import types

import numpy as np

EXACT_KEYS = (
    "assigned_node", "scheduled_priority", "scheduled_mask", "preempted_mask",
    "num_loops", "spot_price",
)
ULP_BOUNDS = {
    "fair_share": 4,
    "demand_capped_fair_share": 4,
    "uncapped_fair_share": 16,
}
# The oracle checks of tests/test_kernel_parity.py's assert_parity.
ORACLE_EXACT = ("assigned_node", "scheduled_mask", "preempted_mask")
ORACLE_RTOL = 1e-12

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PARITY_IMPORT = r"from (?:tests\.)?test_kernel_parity import assert_parity"

# Where the port's rounds solve and what they are held to, `parity`
# setting it for a block of cases; what they solved, and the seconds of
# each part (snapshot, oracle, prep, each path's solve, ending in the
# solve's read back).
PARITY = types.SimpleNamespace(device="cpu", paths=("lax",), reference=None, rounds=0,
                               jobs=0, scheduled=0, preempted=0, seconds={})


@dataclasses.dataclass
class parity:
    """Context manager: solve the port's rounds on `device` and `paths`,
    held to `reference` (a deque, or None) inside the block."""

    device: str = "cpu"
    paths: tuple = ("lax",)
    reference: collections.deque | None = None

    def __enter__(self):
        self._saved = dict(vars(PARITY))
        PARITY.__dict__.update(device=self.device, paths=tuple(self.paths),
                               reference=self.reference, rounds=0, jobs=0, scheduled=0,
                               preempted=0, seconds={})
        return PARITY

    def __exit__(self, *exc):
        PARITY.__dict__.update(self._saved)
        return False


def _ordered(x):
    i = np.ascontiguousarray(x, dtype=np.float64).view(np.int64)
    return np.where(i < 0, np.int64(-(2**63)) - i, i)


def ulps(a, b):
    """Distance of two float64 arrays in units in the last place."""
    return np.abs(_ordered(a) - _ordered(b))


def assert_same_round(label, got, want):
    """The port's outputs `got` against the reference's `want`: the
    decisions, num_loops and spot_price bit for bit, the fair shares
    within ULP_BOUNDS."""
    assert set(got) == set(want), label
    for k in EXACT_KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (label, k)
        assert np.array_equal(g, w, equal_nan=True), f"{label}: {k} diverged from the reference"
    for k, bound in ULP_BOUNDS.items():
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape, (label, k)
        assert int(ulps(g, w).max(initial=0)) <= bound, f"{label}: {k} beyond {bound} ULP"


def assert_same_device_round(label, port_dev, ref_dev):
    """The port's padded round equal to the reference's, field for field
    (the kernel path aside: each package names its own)."""
    names = {f.name for f in dataclasses.fields(ref_dev)} - {"kernel_path"}
    assert names <= {f.name for f in dataclasses.fields(port_dev)}, label
    for name in sorted(names):
        assert canon(getattr(port_dev, name)) == canon(getattr(ref_dev, name)), \
            f"{label}: padded round field {name} differs from the reference's"


def assert_parity(cfg, nodes, queues, running, queued, label="", **snap_kw):
    """The port's twin of tests/test_kernel_parity.py's assert_parity
    (this module's docstring); returns (snapshot, oracle result, the
    first path's outputs trimmed to the round's jobs and queues)."""
    from armada_tpu_torch.snapshot.round import build_round_snapshot
    from armada_tpu_torch.solver.kernel import solve_round
    from armada_tpu_torch.solver.kernel_prep import pad_device_round, prep_device_round
    from armada_tpu_torch.solver.reference import ReferenceSolver

    def timed(part, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        PARITY.seconds[part] = PARITY.seconds.get(part, 0.0) + time.perf_counter() - t0
        return out

    snap = timed("snapshot", build_round_snapshot, cfg, "default", nodes, queues, running,
                 queued, **snap_kw)
    oracle = timed("oracle", ReferenceSolver(snap).solve)
    dev = timed("prep", lambda: pad_device_round(prep_device_round(snap)))
    outs = {
        path: timed(path, solve_round, dataclasses.replace(dev, kernel_path=path),
                    device=PARITY.device)
        for path in PARITY.paths
    }
    first, got = PARITY.paths[0], outs[PARITY.paths[0]]
    for path, out in outs.items():
        assert set(out) == set(got), f"{label}: {path}"
        for k in got:
            assert np.array_equal(np.asarray(out[k]), np.asarray(got[k]), equal_nan=True), \
                f"{label}: {k} differs between the {first} and {path} paths"
    J, Q = snap.num_jobs, snap.num_queues
    out = {
        k: np.asarray(v)[:J] if k.startswith(("assigned", "scheduled", "preempted"))
        else np.asarray(v)[:Q]
        for k, v in got.items()
        if k not in ("num_loops", "spot_price")
    }
    for k in ORACLE_EXACT:
        o, g = np.asarray(getattr(oracle, k)), out[k]
        mism = np.flatnonzero(o != g)
        detail = [(snap.job_ids[j], int(o[j]), int(g[j])) for j in mism[:10]]
        assert not len(mism), f"{label}: {k} differs from the port's oracle {detail}"
    np.testing.assert_allclose(oracle.demand_capped_fair_share,
                               out["demand_capped_fair_share"], rtol=ORACLE_RTOL,
                               err_msg=label)
    if PARITY.reference is not None:
        assert PARITY.reference, f"{label}: the reference solved fewer rounds"
        ref_dev, want = PARITY.reference.popleft()
        assert_same_device_round(label, dev, ref_dev)
        assert_same_round(label, got, want)
    PARITY.rounds += 1
    PARITY.jobs += J
    PARITY.scheduled += int(out["scheduled_mask"].sum())
    PARITY.preempted += int(out["preempted_mask"].sum())
    return snap, oracle, out


def record_reference(monkeypatch):
    """A deque that fills with (padded round, outputs) of every round the
    JAX package's tests/test_kernel_parity.py `assert_parity` solves from
    now on, in order, whichever name its module was imported under."""
    import importlib

    rounds = collections.deque()
    for name in ("test_kernel_parity", "tests.test_kernel_parity"):
        module = importlib.import_module(name)
        solve = module.solve_round

        def recorded(dev, *a, _solve=solve, **k):
            out = _solve(dev, *a, **k)
            rounds.append((dev, {key: np.asarray(v) for key, v in out.items()}))
            return out

        monkeypatch.setattr(module, "solve_round", recorded)
    return rounds


def port_source(name, subs=()):
    """The source of tests/`name`.py with its `armada_tpu` imports
    pointed at the port, its assert_parity at this module's, then each
    (pattern, replacement) of `subs`."""
    with open(os.path.join(TESTS_DIR, f"{name}.py")) as f:
        src = f.read()
    src = re.sub(r"\barmada_tpu(?=[. ])", "armada_tpu_torch", src)
    src = re.sub(PARITY_IMPORT, "from torch_conformance import assert_parity", src)
    for pattern, replacement in subs:
        src, n = re.subn(pattern, replacement, src)
        assert n, f"{name}: {pattern!r} matches nothing"
    return src


def port_module(name, subs=()):
    """tests/`name`.py compiled from `port_source`, as a module."""
    path = os.path.join(TESTS_DIR, f"{name}.py")
    module = types.ModuleType(f"conformance_{name}")
    module.__file__ = path
    exec(compile(port_source(name, subs), path, "exec"), module.__dict__)
    return module


def native_samples():
    """tests/test_native.py's SAMPLES, read from its source: the module
    itself skips where the JAX package's parser is not built."""
    import ast

    with open(os.path.join(TESTS_DIR, "test_native.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "SAMPLES":
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_native.py has no SAMPLES")


FUZZ_SUFFIXES = ["", "m", "k", "M", "G", "Ki", "Mi", "Gi", "Ti", "n", "u"]


def fuzz_quantities(seed=0, n=3000):
    """tests/test_native.py's fuzz, seeded: (quantity, scale, ceil)
    triples."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mant = rng.integers(0, 10**9)
        frac = rng.integers(0, 1000)
        suffix = FUZZ_SUFFIXES[rng.integers(0, len(FUZZ_SUFFIXES))]
        s = f"{mant}.{frac:03d}{suffix}" if rng.random() < 0.5 else f"{mant}{suffix}"
        out.append((s, int(rng.choice([-3, 0, 3])), bool(rng.random() < 0.5)))
    return out


def case_names(module):
    """The test functions of a module, in name order."""
    return sorted(t for t in vars(module) if t.startswith("test_"))


def plain(value):
    import numpy as np

    if isinstance(value, (np.ndarray, np.generic)):
        # Bit for bit: dtype, shape and bytes (NaNs included).
        a = np.asarray(value)
        return ("ndarray", str(a.dtype), a.shape, a.tobytes())
    if isinstance(value, float) and value != value:
        return ("nan",)
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,) + tuple(
            (f.name, plain(getattr(value, f.name))) for f in dataclasses.fields(value)
        )
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return tuple(plain(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return frozenset(plain(v) for v in value)
    return value


def leases_view(jobdb):
    """job id -> (state, executor, node, pool, priority) of its latest
    run: what the scheduler leased, without the random run ids."""
    out = {}
    for j in jobdb.read_txn().all_jobs():
        run = j.latest_run
        out[j.id] = (
            j.state.value,
            j.num_attempts,
            None if run is None else (
                run.executor, run.node_id, run.pool, run.scheduled_at_priority, run.state.value,
            ),
        )
    return out


def record_cycles(monkeypatch, module):
    """Record the leases after every cycle of every SchedulerService of
    the scheduler module `module` that cycles in this process's own
    threads: one history per service, in the order the services first
    cycle. What-if rollouts are left out: the JAX package runs them on
    its planner's threads (named "whatif"), the port in rollout
    processes of its own, where nothing here can record their cycles;
    tests/test_torch_whatif.py compares their plans and the leases and
    preemptions each rollout sends back."""
    import threading

    histories = []
    cycle = module.SchedulerService.cycle

    def recorded(self, *a, **k):
        out = cycle(self, *a, **k)
        if threading.current_thread().name.startswith("whatif"):
            return out
        history = self.__dict__.get("_recorded_cycles")
        if history is None:
            history = self.__dict__["_recorded_cycles"] = []
            histories.append(history)
        history.append(leases_view(self.jobdb))
        return out

    monkeypatch.setattr(module.SchedulerService, "cycle", recorded)
    return histories


_SKIP_FIELDS = {
    # A process-wide counter of each package (core/resources.py).
    "ResourceListFactory": {"serial"},
    # Each package's own default kernel path ("lax"; the port's "cuda").
    "SchedulingConfig": {"solve_kernel_path"},
}


def canon(value):
    """`value` in a form that compares with `==` across the two packages:
    the `plain` form, but for the fields of _SKIP_FIELDS, which differ
    between the packages by design."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        name = type(value).__name__
        skip = _SKIP_FIELDS.get(name, ())
        return (name,) + tuple(
            (f.name, canon(getattr(value, f.name)))
            for f in dataclasses.fields(value) if f.name not in skip
        )
    if isinstance(value, dict):
        return {canon(k): canon(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return tuple(canon(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return frozenset(canon(v) for v in value)
    return plain(value)


def record_calls(monkeypatch, targets):
    """Wrap each (owner, attribute) of `targets`, a function or a method,
    so that every call appends (attribute, canon(result)), or
    (attribute, "raises", exception type) when it raises, to the list
    returned."""
    import inspect

    calls = []
    for owner, attr in targets:
        raw = inspect.getattr_static(owner, attr)
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else getattr(owner, attr)

        def recorded(*a, _fn=fn, _attr=attr, **k):
            try:
                out = _fn(*a, **k)
            except Exception as e:
                calls.append((_attr, "raises", type(e).__name__))
                raise
            calls.append((_attr, canon(out)))
            return out

        monkeypatch.setattr(owner, attr, staticmethod(recorded) if static else recorded)
    return calls
