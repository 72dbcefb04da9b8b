"""Carry control-plane state across from the JAX package.

A scheduler's state is its event log and its job database; what the
port needs to take over a JAX-package deployment is that state as the
port's own records. `to_port` rebuilds a value — dataclass instances,
enum members, and the tuples, lists, sets and dicts that hold them —
with every class swapped for the port's class of the same module path
and name (`armada_tpu.jobdb.jobdb.Job` -> `armada_tpu_torch.jobdb.jobdb.Job`).
It reads the value's dataclass fields and enum values only, and imports
nothing of the JAX package: the class names come from the objects. The
query side's records carry the same way: a Lookout view's rows and runs
(`services.lookout_ingester.LookoutRow`, `LookoutRun`), the query API's
rows, filters and orders (`services.queryapi.JobRow`, `JobFilter`,
`Order`); the rows' run ids are the scheduler's, drawn at random. So do
the records an executor's lease exchange leaves in the scheduler
(`services.scheduler.ExecutorHeartbeat` and its `core.types.NodeSpec`s,
with their `Taint`s), which the wire's handlers build from the agent's
node dicts.

Used by `events.log.from_reference_events` and
`services.scheduler.from_reference_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib

REFERENCE_PACKAGE = "armada_tpu"
PORT_PACKAGE = "armada_tpu_torch"


def _port_class(cls):
    module = cls.__module__
    head, _, rest = module.partition(".")
    if head != REFERENCE_PACKAGE:
        return cls
    port = importlib.import_module(f"{PORT_PACKAGE}.{rest}" if rest else PORT_PACKAGE)
    try:
        return getattr(port, cls.__qualname__)
    except AttributeError:
        raise TypeError(f"{module}.{cls.__qualname__} has no counterpart in {port.__name__}") from None


def to_port(value):
    """`value` with every JAX-package dataclass and enum replaced by the
    port's; values of other types pass through unchanged."""
    if isinstance(value, enum.Enum):
        return _port_class(type(value))(value.value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = _port_class(type(value))
        fields = dataclasses.fields(value)
        out = cls(**{f.name: to_port(getattr(value, f.name)) for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(out, f.name, to_port(getattr(value, f.name)))
        return out
    if isinstance(value, dict):
        return {to_port(k): to_port(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return type(value)(to_port(v) for v in value)
    return value
