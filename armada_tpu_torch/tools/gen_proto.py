"""Regenerate armada_tpu_torch/proto/armada_pb2.py without protoc.

The container carries no protoc/grpc_tools, so schema changes are
applied as FileDescriptorProto surgery: load the current generated
module's serialized descriptor, append any message/field declared in
SCHEMA_ADDITIONS that is not already present, and re-emit the generated
module with the new serialized bytes. `proto/armada.proto` remains the
canonical human-readable schema — edit it AND mirror the change here,
then run:

    python -m armada_tpu_torch.tools.gen_proto --write   # rewrite armada_pb2.py
    python -m armada_tpu_torch.tools.gen_proto --check   # verify nothing is missing

Idempotent: re-running against an up-to-date module writes nothing.

This is the port's copy of the JAX package's tools/gen_proto.py, over the
port's bindings. Both packages bind the one schema, and their
`armada_pb2.py` files are byte for byte the same: two different files
named `armada.proto` in one process's descriptor pool would conflict,
while identical bytes share one descriptor, so a process may hold both
packages' messages.
"""

from __future__ import annotations

import argparse
import os
import sys

from google.protobuf import descriptor_pb2

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PB2_PATH = os.path.join(REPO, "armada_tpu_torch", "proto", "armada_pb2.py")

F = descriptor_pb2.FieldDescriptorProto
# (name, number, type, label, type_name)
_T = {
    "string": F.TYPE_STRING,
    "uint32": F.TYPE_UINT32,
    "double": F.TYPE_DOUBLE,
    "bool": F.TYPE_BOOL,
    "message": F.TYPE_MESSAGE,
}

# New messages for the what-if planner RPCs (WhatIf / PlanDrain /
# ExecuteDrain on the binary-protobuf wire). Field names match the JSON
# wire exactly (json_format bridging, services/grpc_api.py). Plan and
# status payloads travel as JSON strings: the Plan is a deep structured
# document (displacements, gang outcomes, headroom) whose natural wire
# form is the same JSON both other surfaces serve.
SCHEMA_ADDITIONS = {
    "WhatIfMutation": [
        ("kind", 1, "string"),
        ("name", 2, "string"),
        ("queue", 3, "string"),
        ("count", 4, "uint32"),
        ("gang_cardinality", 5, "uint32"),
        ("cpu", 6, "string"),
        ("memory", 7, "string"),
        ("gpu", 8, "string"),
        ("priority_class", 9, "string"),
        ("weight", 10, "double"),
        ("executor", 11, "string"),
        ("deadline_s", 12, "double"),
    ],
    "WhatIfRequest": [
        ("pool", 1, "string"),
        ("solver", 2, "string"),
        ("rounds", 3, "uint32"),
        ("mutations", 4, "message", "repeated", ".armada_tpu.api.WhatIfMutation"),
    ],
    "WhatIfResponse": [
        ("plan_json", 1, "string"),
        ("rendered", 2, "string"),
    ],
    "PlanDrainRequest": [
        ("executor", 1, "string"),
        ("pool", 2, "string"),
        ("solver", 3, "string"),
        ("rounds", 4, "uint32"),
        ("deadline_s", 5, "double"),
    ],
    "PlanDrainResponse": [
        ("plan_json", 1, "string"),
        ("rendered", 2, "string"),
    ],
    "ExecuteDrainRequest": [
        ("executor", 1, "string"),
        ("deadline_s", 2, "double"),
        ("status_only", 3, "bool"),
    ],
    "ExecuteDrainResponse": [
        ("status_json", 1, "string"),
    ],
}

# Fields appended to EXISTING messages: message -> [(name, number, type)].
FIELD_ADDITIONS = {
    # Drain preempt-requeue flag (events/model.py JobRunPreempted):
    # requeue=True kills the run but returns the job to QUEUED.
    "JobRunPreempted": [("requeue", 5, "bool")],
}

TEMPLATE = '''# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: armada.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({serialized!r})

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'armada_pb2', globals())
# @@protoc_insertion_point(module_scope)
'''


def _make_field(spec) -> F:
    name, number, ftype = spec[0], spec[1], spec[2]
    label = spec[3] if len(spec) > 3 else "optional"
    type_name = spec[4] if len(spec) > 4 else None
    f = F()
    f.name = name
    f.number = number
    f.type = _T[ftype]
    f.label = F.LABEL_REPEATED if label == "repeated" else F.LABEL_OPTIONAL
    if type_name:
        f.type_name = type_name
    return f


def updated_descriptor() -> tuple[bytes, list[str]]:
    """(new serialized FileDescriptorProto, list of applied changes)."""
    sys.path.insert(0, REPO)
    from armada_tpu_torch.proto import armada_pb2 as pb

    fdp = descriptor_pb2.FileDescriptorProto.FromString(
        pb.DESCRIPTOR.serialized_pb
    )
    have = {m.name: m for m in fdp.message_type}
    changes = []
    for name, fields in FIELD_ADDITIONS.items():
        msg = have.get(name)
        if msg is None:
            raise SystemExit(f"message {name} missing from the descriptor")
        existing = {f.name for f in msg.field}
        for spec in fields:
            if spec[0] in existing:
                continue
            msg.field.append(_make_field(spec))
            changes.append(f"{name}.{spec[0]}")
    for name, fields in SCHEMA_ADDITIONS.items():
        if name in have:
            continue
        msg = fdp.message_type.add()
        msg.name = name
        for spec in fields:
            msg.field.append(_make_field(spec))
        changes.append(name)
    return fdp.SerializeToString(), changes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true",
                    help="rewrite armada_pb2.py when changes are needed")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the generated module is stale")
    args = ap.parse_args(argv)
    serialized, changes = updated_descriptor()
    if not changes:
        print("armada_pb2.py is up to date")
        return 0
    if args.check and not args.write:
        print(f"armada_pb2.py is STALE; missing: {', '.join(changes)}")
        return 1
    if args.write:
        with open(PB2_PATH, "w") as f:
            f.write(TEMPLATE.format(serialized=serialized))
        print(f"wrote {PB2_PATH} (+{len(changes)}: {', '.join(changes)})")
        return 0
    print(f"would add: {', '.join(changes)} (pass --write)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
