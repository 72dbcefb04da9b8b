"""Solver autopilot: profile-driven parameter autotuning.

Three parts close the loop over the two subsystems that already exist:

  - `offline.tune_corpus` searches candidate parameter vectors by
    replaying a recorded `.atrace` corpus (trace/) per candidate,
    requiring bit-exact placements, and selects the fastest qualifying
    vector (`python -m armada_tpu_torch.tools.autotune` is the CLI);
  - `controller.AutotuneController` adjusts perf-only knobs between
    live rounds — a bounded hill-climb with hysteresis driven by the
    solve profile's rewindow rate and pass1/gather split;
  - `store.TuningStore` persists both producers' adoptions across
    restart (via services/checkpoint.CheckpointStore) keyed by target
    signature + workload fingerprint, pool-aware.

Placement safety is structural: every tunable knob (hot-window size,
engagement floor, budgeted chunk stride) is bit-exact with the
uncompacted kernel by construction, so autotuning can change how fast
a round solves, never what it decides.

This is the port's copy of the JAX package's autotune/ package: the
same decisions, the same store and profile formats, solving on the card
(or on the CPU where the caller asks for it).
"""

from .controller import AutotuneController
from .offline import (
    baseline_params,
    default_grid,
    tune_corpus,
    workload_fingerprint,
)
from .store import (
    TunedParams,
    TuningStore,
    current_target,
    make_entry,
    target_digest,
)

__all__ = [
    "AutotuneController",
    "TunedParams",
    "TuningStore",
    "baseline_params",
    "current_target",
    "default_grid",
    "make_entry",
    "target_digest",
    "tune_corpus",
    "workload_fingerprint",
]
