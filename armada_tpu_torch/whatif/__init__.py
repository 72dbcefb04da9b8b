"""What-if planner: forked-snapshot shadow solves for drain
orchestration, gang ETA and capacity headroom.

The subsystem answers operational questions without touching the live
fleet: "what breaks if I drain executor X", "when would a 64-chip gang
start if I submitted it now", "how much headroom does pool P have" —
by forking the scheduler's last round state (`fork.py`), applying
composable hypothetical edits (`mutations.py`), and re-solving the
mutated fork with the UNCHANGED production kernel under any solver
spec (`planner.py`), diffing the decisions against the live round.
`drain.py` turns a drain plan into staged execution through the real
control-plane event path, with dry-run and execution required to agree
in a deterministic sim (tests/test_torch_whatif.py).

Gavel-style what-if policy evaluation (PAPERS: arXiv:2008.09213) made
cheap by the solver's replay machinery: planner solves are bit-exact
with the live kernel on an unmutated fork, and run on a bounded worker
pool off the round thread (a planner burst adds zero live latency).

This is the port's copy of the JAX package's whatif/ package; its
shadow solves run on the live scheduler's device (the CUDA card unless
the service runs on the CPU), and a plan's rollout runs in a worker
process of its own (`worker.py`), so that its host loop never holds the
live process's interpreter lock.
"""

from .drain import DrainController, DrainCoordinator
from .fork import ForkCapture, ForkState, RoundFork, fork_from_scheduler, fork_from_trace
from .mutations import Mutation, mutation_from_dict, mutations_from_dicts
from .planner import Plan, WhatIfBusyError, WhatIfService
from .worker import RolloutWorkerDied

__all__ = [
    "DrainController",
    "DrainCoordinator",
    "ForkCapture",
    "ForkState",
    "RoundFork",
    "fork_from_scheduler",
    "fork_from_trace",
    "Mutation",
    "mutation_from_dict",
    "mutations_from_dicts",
    "Plan",
    "RolloutWorkerDied",
    "WhatIfBusyError",
    "WhatIfService",
]
