"""Serialisation of DeviceRound inputs and decision streams.

A `.atrace` bundle is append-only JSON lines: one header record, then
one record per recorded round. Numpy arrays travel as raw little-endian
bytes (base64) tagged with dtype + shape, so the decode is a bit-exact
reconstruction — not a float round-trip through decimal text. Each line
then rides through `utils.compress.compress_obj` (the lease-stream zlib
marker format), which is what keeps a committed fixture trace small.

Python-scalar fields of DeviceRound (the jit meta fields plus floats
like `global_tokens`) are encoded with their host type preserved: a
replayed round must hand the kernel EXACTLY the pytree the recorded
round did — a float that came back as a 0-d array would change weak-
type promotion inside the compiled program.
"""

from __future__ import annotations

import base64
import dataclasses
import json

import numpy as np

from ..solver.kernel_prep import DeviceRound
from ..utils.compress import compress_obj, decompress_obj

FORMAT = "atrace/1"


class TraceFormatError(ValueError):
    """The bundle does not decode under this build's trace schema."""


def encode_field(value):
    """JSON-encodable tagging of one DeviceRound field / decision value."""
    if isinstance(value, np.generic):
        # BEFORE the plain-scalar branch: np.float64 subclasses float, and
        # flattening it to a JSON number would decode as a weak-typed
        # Python float where the recorded pytree had a strong numpy
        # scalar (spot_price_cutoff) — a different jit signature.
        return encode_field(np.asarray(value))
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, tuple):
        return {"__tuple__": [encode_field(v) for v in value]}
    arr = np.asarray(value)
    # Little-endian on the wire whatever the host: '<' prefix pins it.
    dt = arr.dtype.newbyteorder("<")
    return {
        "__nd__": str(dt),
        "shape": list(arr.shape),
        "b64": base64.b64encode(np.ascontiguousarray(arr.astype(dt)).tobytes()).decode(),
    }


def decode_field(value):
    if isinstance(value, dict) and "__tuple__" in value:
        return tuple(decode_field(v) for v in value["__tuple__"])
    if isinstance(value, dict) and "__nd__" in value:
        raw = base64.b64decode(value["b64"])
        arr = np.frombuffer(raw, dtype=np.dtype(value["__nd__"]))
        # .copy(): frombuffer views are read-only; kernels and pad paths
        # expect ordinary writable host arrays. Also drops the explicit
        # byte-order tag back to native.
        arr = arr.reshape(value["shape"]).astype(np.dtype(value["__nd__"]).newbyteorder("=")).copy()
        if not value["shape"]:
            # 0-d payloads were numpy scalars (e.g. spot_price_cutoff).
            return arr[()]
        return arr
    return value


def encode_device_round(dev: DeviceRound) -> dict:
    return {
        f.name: encode_field(getattr(dev, f.name))
        for f in dataclasses.fields(DeviceRound)
    }


# Fields added after atrace/1 shipped, with the exact value every older
# bundle's rounds ran under. Decoding substitutes ONLY these — anything
# else missing is still a schema error. queue_deadline derives its Q
# from the decoded queue_weight.
_COMPAT_DEFAULTS = {
    "fairness_policy": lambda doc: ("drf",),
    # Solve-kernel selection (ops/pallas_kernels.py) postdates every
    # pre-pallas bundle; those rounds all ran the lax graph.
    "kernel_path": lambda doc: "lax",
    "queue_deadline": lambda doc: np.full(
        np.asarray(decode_field(doc["queue_weight"])).shape[0],
        np.inf,
        dtype=np.float64,
    ),
}


def decode_device_round(doc: dict) -> DeviceRound:
    fields = {f.name for f in dataclasses.fields(DeviceRound)}
    missing = fields - doc.keys()
    unknown = doc.keys() - fields
    defaulted = {k for k in missing if k in _COMPAT_DEFAULTS}
    missing -= defaulted
    if missing or unknown:
        raise TraceFormatError(
            "trace DeviceRound schema mismatch vs this build: "
            f"missing={sorted(missing)} unknown={sorted(unknown)} — "
            "re-record the trace against the current kernel inputs"
        )
    out = {k: decode_field(v) for k, v in doc.items()}
    for k in defaulted:
        out[k] = _COMPAT_DEFAULTS[k](doc)
    return DeviceRound(**out)


def encode_record(record: dict) -> str:
    """One .atrace line (zlib-wrapped when it pays off)."""
    return json.dumps(compress_obj(record, min_size=256), separators=(",", ":"))


def decode_record(line: str) -> dict:
    try:
        return decompress_obj(json.loads(line))
    except (json.JSONDecodeError, ValueError) as e:
        raise TraceFormatError(f"undecodable trace line: {e}") from e
