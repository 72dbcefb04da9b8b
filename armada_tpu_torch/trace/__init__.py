"""Flight recorder: round-trace capture and deterministic replay.

A trace (`.atrace` bundle) is the production-shaped regression corpus
trace-driven evaluations are built on: each scheduler round's solver
inputs (the padded DeviceRound, bit-for-bit), the config fingerprint,
the RNG/fault-plan seeds, and the decision stream the solver produced
(placements, evictions, fair shares, pass-1 loop count, per-segment
profile). Record once — from the live service or the simulator — then
replay the round under ANY solver spec (LOCAL on the hand-written
kernels, "lax", a "2x2" mesh, hot-window on/off) and diff placements
against the recorded decisions. `armada_tpu_torch/tools/replay_gate.py`
turns that diff into a gate for candidate kernels.

This is the port's copy of the JAX package's trace/ package and reads
and writes the same `atrace/1` bundles, so a recording of either
package replays on the other.
"""

from .codec import (
    TraceFormatError,
    decode_device_round,
    decode_record,
    encode_device_round,
    encode_record,
)
from .recorder import DECISION_KEYS, TraceRecorder
from .replayer import (
    TraceTargetMismatch,
    check_target,
    compare_round,
    load_trace,
    perturb_device_round,
    replay_solver,
    replay_trace,
)

__all__ = [
    "DECISION_KEYS",
    "TraceFormatError",
    "TraceRecorder",
    "TraceTargetMismatch",
    "check_target",
    "compare_round",
    "decode_device_round",
    "decode_record",
    "encode_device_round",
    "encode_record",
    "load_trace",
    "perturb_device_round",
    "replay_solver",
    "replay_trace",
]
