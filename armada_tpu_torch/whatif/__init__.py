"""The what-if subsystem's staged executor drains (drain.py), which the
scheduler service steps every cycle. The planner (forked snapshots,
mutations, shadow solves) waits for ROADMAP A1."""

from .drain import DrainController, DrainCoordinator

__all__ = ["DrainController", "DrainCoordinator"]
