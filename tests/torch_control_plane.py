"""Helpers of the port's control-plane tests: the same stack built from
the JAX package and from the port, and the plain form their records are
compared in.

`plain`, `leases_view` and `record_cycles` are tests/torch_conformance.py's,
re-exported (chip_smoke.py's phase 19 uses them with no JAX package).
`plain` turns dataclasses and enums of either package into dicts,
tuples and values, and numpy arrays into their dtype, shape and bytes,
so a reference record and a port record compare with `==`, exactly.
`to_reference` carries a port value to the reference (the inverse of the
port's `utils.carry.to_port`), and `twinned` runs a port function and
its reference counterpart on the same inputs and holds them equal.
`jobdb_view` is a job database in that form, keyed by job id; with
`run_ids=False` it drops the run ids, which the scheduler draws at random
(`events.model.new_id`), so two services fed the same events compare
equal. `lookout_view` is a Lookout store's rows (`LookoutRow`, its
`LookoutRun`s) the same way, and `scrub_run_ids` replaces a package's run
ids wherever they appear in a query result or an HTTP body (`JobRow`,
job details, log lines). `Package` gathers one package's control-plane classes under the
same names, so a test case is written once and run against both.

`port_copy` compiles a reference test module again with its
`armada_tpu` imports pointed at the port, and `run_side_by_side` runs
one of its cases on both packages, recording the leases after every
cycle of every scheduler service (`record_cycles`). A case's fixtures
are the module's own (built per call, torn down after it), or values
the caller gives per package (a module-scoped fixture's).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import importlib
import inspect
import re
import types

from torch_conformance import leases_view, plain, record_cycles  # noqa: F401


def job_view(job, run_ids=True):
    row = dict(
        spec=plain(job.spec),
        state=job.state.value,
        priority=job.priority,
        submitted=job.submitted,
        failed_nodes=tuple(job.failed_nodes),
        error=job.error,
        error_category=job.error_category,
        runs=tuple(
            dict(plain(run)[1:], **({} if run_ids else {"id": None}))
            for run in job.runs
        ),
    )
    return row


def jobdb_view(jobdb, run_ids=True):
    return {j.id: job_view(j, run_ids) for j in jobdb.read_txn().all_jobs()}


def lookout_view(store, run_ids=True):
    """job id -> a Lookout store's row (in-memory or SQLite) in the plain
    form; with `run_ids=False` each run's id is None."""
    out = {}
    for row in store.all_rows():
        rec = dict(plain(row)[1:])
        if not run_ids:
            rec["runs"] = tuple(dict(plain(r)[1:], run_id=None) for r in row.runs)
        out[row.job_id] = rec
    return out


def run_ids_of(jobdb):
    return {r.id for j in jobdb.read_txn().all_jobs() for r in j.runs}


def scrub_run_ids(value, run_ids):
    """`value` in the plain form with every string that holds one of
    `run_ids` (the package's own, `run_ids_of`) holding "<run>" there."""
    value = plain(value)
    if isinstance(value, str):
        for rid in run_ids:
            if rid in value:
                value = value.replace(rid, "<run>")
        return value
    if isinstance(value, dict):
        return {scrub_run_ids(k, run_ids): scrub_run_ids(v, run_ids) for k, v in value.items()}
    if isinstance(value, (tuple, frozenset)):
        return type(value)(scrub_run_ids(v, run_ids) for v in value)
    return value


class Package(types.SimpleNamespace):
    """One package's control-plane classes under common names. The
    port's SchedulerService and Simulator solve on the CPU."""

    def __init__(self, name):
        m = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
        port = name == "armada_tpu_torch"
        sched = m("services.scheduler").SchedulerService
        sim = m("sim.simulator")
        super().__init__(
            name=name,
            PriorityClass=m("core.config").PriorityClass,
            SchedulingConfig=m("core.config").SchedulingConfig,
            Gang=m("core.types").Gang,
            JobSpec=m("core.types").JobSpec,
            QueueSpec=m("core.types").QueueSpec,
            NodeSpec=m("core.types").NodeSpec,
            events=m("events"),
            InMemoryEventLog=m("events").InMemoryEventLog,
            JobState=m("jobdb").JobState,
            FakeExecutor=m("services.fake_executor").FakeExecutor,
            make_nodes=m("services.fake_executor").make_nodes,
            FaultPlan=m("services.chaos").FaultPlan,
            FaultSpec=m("services.chaos").FaultSpec,
            SchedulerService=functools.partial(sched, device="cpu") if port else sched,
            SubmitService=m("services.submit").SubmitService,
            SubmissionError=m("services.submit").SubmissionError,
            sim=sim,
            Simulator=functools.partial(sim.Simulator, device="cpu") if port else sim.Simulator,
        )


REF = Package("armada_tpu")
PORT = Package("armada_tpu_torch")


def _reference_class(cls):
    module = cls.__module__
    head, _, rest = module.partition(".")
    if head != "armada_tpu_torch":
        return cls
    ref = importlib.import_module(f"armada_tpu.{rest}" if rest else "armada_tpu")
    return getattr(ref, cls.__qualname__)


def to_reference(value):
    """`value` with every port dataclass and enum replaced by the JAX
    package's of the same module path and name: the inverse of the
    port's `utils.carry.to_port`, for feeding a port input to the
    reference."""
    if isinstance(value, enum.Enum):
        return _reference_class(type(value))(value.value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = _reference_class(type(value))
        fields = dataclasses.fields(value)
        out = cls(**{f.name: to_reference(getattr(value, f.name)) for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(out, f.name, to_reference(getattr(value, f.name)))
        return out
    if isinstance(value, dict):
        return {to_reference(k): to_reference(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return type(value)(to_reference(v) for v in value)
    return value


def twinned(port_fn, ref_fn):
    """`port_fn` that also runs `ref_fn` on the same inputs carried to the
    reference (`to_reference`; callables among them get the reference's
    arguments carried back with `to_port`) and asserts that both return
    the same value and leave their mutable arguments the same, in the
    plain form, compared exactly."""
    import copy

    from armada_tpu_torch.utils.carry import to_port

    def carry(v):
        if callable(v) and not isinstance(v, type) and not dataclasses.is_dataclass(v):
            return lambda *a, **k: v(*to_port(a), **to_port(k))
        return to_reference(copy.deepcopy(v))

    def call(*args, **kwargs):
        ref_args = [carry(a) for a in args]
        ref_kwargs = {k: carry(v) for k, v in kwargs.items()}
        got = port_fn(*args, **kwargs)
        want = ref_fn(*ref_args, **ref_kwargs)
        assert plain(got) == plain(want), port_fn.__name__
        for i, (a, b) in enumerate(zip(args, ref_args)):
            if isinstance(a, dict):
                assert plain(a) == plain(b), f"{port_fn.__name__}: argument {i}"
        return got

    return call


_COPIES: dict = {}


def port_copy(name, subs=(), *, port=True):
    """The reference test module `name`, compiled again from its source
    with `armada_tpu` imports pointed at `armada_tpu_torch` (with
    `port=False`, left as they are), then each (pattern, replacement)
    regex of `subs` applied."""
    key = (name, tuple(subs), port)
    if key not in _COPIES:
        ref = importlib.import_module(name)
        with open(ref.__file__) as f:
            src = f.read()
        if port:
            src = re.sub(r"\barmada_tpu(?=[. ])", "armada_tpu_torch", src)
        for pattern, replacement in subs:
            src, n = re.subn(pattern, replacement, src)
            assert n, f"{name}: {pattern!r} matches nothing"
        module = types.ModuleType(f"{'torch_port' if port else 'variant'}_{name}")
        module.__file__ = ref.__file__
        exec(compile(src, ref.__file__, "exec"), module.__dict__)
        _COPIES[key] = module
    return _COPIES[key]


def case_marks(name, test):
    """The pytest marks of the reference case `name`::`test` (slow,
    skipif), to put on its side-by-side case."""
    return list(getattr(getattr(importlib.import_module(name), test), "pytestmark", []))


def _call_case(module, fn, args, tmp_dir, given):
    """`fn(*args, **fixtures)`: `tmp_path` is `tmp_dir`, a name in
    `given` takes its value, any other fixture is the module's own,
    built once per call (its own fixtures resolved the same way) and
    torn down after the call, last built first."""
    built, teardown = {}, []

    def resolve(arg):
        if arg in built:
            return built[arg]
        if arg == "tmp_path":
            tmp_dir.mkdir(exist_ok=True)
            value = tmp_dir
        elif arg in given:
            value = given[arg]
        else:
            fixture = getattr(module, arg, None)
            assert hasattr(fixture, "_get_wrapped_function"), f"{fn.__name__}: fixture {arg!r}"
            wrapped = fixture._get_wrapped_function()
            value = wrapped(**{p: resolve(p) for p in inspect.signature(wrapped).parameters})
            if inspect.isgenerator(value):
                teardown.append(value)
                value = next(value)
        built[arg] = value
        return value

    try:
        params = list(inspect.signature(fn).parameters)[len(args):]
        return fn(*args, **{arg: resolve(arg) for arg in params})
    finally:
        for gen in reversed(teardown):
            next(gen, None)


def run_side_by_side(name, test, monkeypatch, tmp_path, *, args=(), subs=(), port_subs=(),
                     first_only=False, cycles=True, given=({}, {})):
    """Run the reference case `name`::`test`, then its port copy with the
    port's default device set to the CPU; each case's own assertions
    hold on both. `subs` rewrite both sides (a variant of the case, say
    on another backend), `port_subs` the port's alone (its CLI in place
    of the reference's script). The leases after every cycle are equal
    service by service (with `first_only`, the first service's alone: a
    case whose other services run on threads in an order of their own).
    With `cycles=False` they are not compared: a case whose control
    plane cycles on the wall clock, in a thread of its own, sees as many
    cycles as the machine's timing gives it, on either package.
    A case's `tmp_path` argument is a directory of its own per package;
    its other fixtures are the module's (`_call_case`) or, by name, the
    values of `given` (the reference's, the port's); `args` go to both
    calls (a helper of the module run as a case). Returns both calls'
    return values (reference, port)."""
    import armada_tpu.services.scheduler as ref_scheduler
    import armada_tpu_torch.device as port_device
    import armada_tpu_torch.services.scheduler as port_scheduler

    def record(module):
        return record_cycles(monkeypatch, module) if cycles else []

    ref_module = port_copy(name, subs, port=False) if subs else importlib.import_module(name)
    ref_history = record(ref_scheduler)
    ref_out = _call_case(ref_module, getattr(ref_module, test), args, tmp_path / "ref", given[0])
    monkeypatch.setattr(port_device, "DEFAULT_DEVICE", "cpu")
    port_history = record(port_scheduler)
    port_module = port_copy(name, tuple(subs) + tuple(port_subs))
    port_out = _call_case(port_module, getattr(port_module, test), args, tmp_path / "port",
                          given[1])
    if first_only:
        ref_history, port_history = ref_history[:1], port_history[:1]
    assert len(port_history) == len(ref_history)
    for k, (p, r) in enumerate(zip(port_history, ref_history)):
        assert len(p) == len(r), f"service {k}"
        for i, (a, b) in enumerate(zip(p, r)):
            assert a == b, f"service {k}, cycle {i}"
    return ref_out, port_out
