"""Payload compression for the lease stream.

Mirrors internal/common/compress/ (zlib compressor used by
the scheduler API to shrink jobspecs in JobRunLease replies,
internal/scheduler/api.go): payloads over a threshold travel as
base64(zlib) with a marker so readers stay compatible with plain JSON.
"""

from __future__ import annotations

import base64
import json
import zlib

# Payloads smaller than this aren't worth compressing (the reference uses
# a pooled zlib compressor with a minimum size too).
DEFAULT_MIN_SIZE = 512


def compress_obj(obj, min_size: int = DEFAULT_MIN_SIZE):
    """JSON-encode and zlib-compress an object when it pays off. Returns
    either the object itself (small) or {"__zlib__": base64}."""
    raw = json.dumps(obj).encode()
    if len(raw) < min_size:
        return obj
    packed = zlib.compress(raw, level=6)
    if len(packed) >= len(raw):
        return obj
    return {"__zlib__": base64.b64encode(packed).decode()}


def decompress_obj(obj):
    """Inverse of compress_obj; plain objects pass through."""
    if isinstance(obj, dict) and "__zlib__" in obj and len(obj) == 1:
        raw = zlib.decompress(base64.b64decode(obj["__zlib__"]))
        return json.loads(raw.decode())
    return obj
