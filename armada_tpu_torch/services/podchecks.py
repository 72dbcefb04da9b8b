"""Pod issue detection: configurable stuck/failed pod checks.

Mirrors internal/executor/podchecks/{pod_checks,
event_checks,container_state_checks,action}.go and the pod-issue service
(internal/executor/service/pod_issue_handler.go): pods that sit in a
non-running state too long are examined against configured event-message
and container-state checks, each with a grace period, deciding WAIT,
RETRY (report a retryable run error so the scheduler reschedules) or
FAIL (fatal). The strongest action wins (maxAction, action.go), and a
stuck-terminating expiry force-kills pods that ignore their cancel.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field


class Action(enum.IntEnum):
    WAIT = 0
    RETRY = 1
    FAIL = 2


def max_action(a: Action, b: Action) -> Action:
    """maxAction (action.go): the strongest action wins."""
    return a if a >= b else b


@dataclass(frozen=True)
class EventCheck:
    """One entry of podchecks config `events` (event_checks.go:19-27)."""

    regexp: str
    event_type: str = "Warning"  # "Warning" | "Normal"
    grace_period_s: float = 0.0
    action: Action = Action.RETRY
    inverse: bool = False
    name: str = ""

    def matches(self, event: dict, time_in_state: float) -> bool:
        if event.get("type", "Warning") != self.event_type:
            return False
        hit = re.search(self.regexp, event.get("message", "")) is not None
        if self.inverse == hit:  # inverse XOR match (event_checks.go:90)
            return False
        return time_in_state > self.grace_period_s


@dataclass(frozen=True)
class ContainerStateCheck:
    """One entry of podchecks config `containerStatuses`
    (container_state_checks.go)."""

    state: str  # "waiting"
    reason_regexp: str
    grace_period_s: float = 0.0
    action: Action = Action.RETRY
    inverse: bool = False

    def matches(self, container: dict, time_in_state: float) -> bool:
        if container.get("state") != self.state:
            return False
        hit = re.search(self.reason_regexp, container.get("reason", "")) is not None
        if self.inverse == hit:
            return False
        return time_in_state > self.grace_period_s


@dataclass(frozen=True)
class PodChecksConfig:
    events: tuple[EventCheck, ...] = ()
    container_statuses: tuple[ContainerStateCheck, ...] = ()
    # Pod not assigned to a node within this deadline -> retry
    # (pod_checks.go:81-83).
    deadline_for_node_assignment_s: float = 300.0
    # No status updates at all within this deadline -> node likely bad ->
    # retry (pod_checks.go:85-90).
    deadline_for_updates_s: float = 600.0
    # Cancelled pods that refuse to terminate are force-killed and
    # reported after this (pod_issue_handler.go stuck-terminating expiry).
    stuck_terminating_expiry_s: float = 300.0


DEFAULT_CHECKS = PodChecksConfig(
    events=(
        EventCheck(
            regexp=r"Insufficient .*|node\(s\) didn.t match",
            event_type="Warning",
            grace_period_s=120.0,
            action=Action.RETRY,
            name="unschedulable",
        ),
        EventCheck(
            regexp=r"Failed to pull image|ErrImagePull|ImagePullBackOff",
            event_type="Warning",
            grace_period_s=60.0,
            action=Action.FAIL,
            name="image-pull",
        ),
    ),
    container_statuses=(
        ContainerStateCheck(
            state="waiting",
            reason_regexp="ContainerCreating",
            grace_period_s=600.0,
            action=Action.RETRY,
        ),
        ContainerStateCheck(
            state="waiting",
            reason_regexp="CreateContainerConfigError|InvalidImageName",
            grace_period_s=0.0,
            action=Action.FAIL,
        ),
    ),
)


class PodChecker:
    """PodChecks.GetAction (pod_checks.go:54-110) over our pod records.

    A pod record carries: phase, last_change (ts), node (or ""), events
    (list of {type, message}), containers (list of {state, reason})."""

    def __init__(self, config: PodChecksConfig = DEFAULT_CHECKS):
        self.config = config

    def get_action(self, pod: dict, now: float) -> tuple[Action, str]:
        cfg = self.config
        time_in_state = now - pod.get("last_change", pod.get("created", now))
        messages: list[str] = []

        if not pod.get("node") and time_in_state > cfg.deadline_for_node_assignment_s:
            return (
                Action.RETRY,
                f"pod not assigned to a node within "
                f"{cfg.deadline_for_node_assignment_s}s deadline",
            )

        events = pod.get("events", ())
        containers = pod.get("containers", ())
        if (
            not events
            and not containers
            and time_in_state > cfg.deadline_for_updates_s
        ):
            return (
                Action.RETRY,
                f"pod received no updates within {cfg.deadline_for_updates_s}s"
                " — node likely bad",
            )

        result = Action.WAIT
        for event in events:
            for check in cfg.events:  # first matching check decides
                if check.matches(event, time_in_state):
                    result = max_action(result, check.action)
                    messages.append(
                        f"event check {check.name or check.regexp}: "
                        f"{event.get('message', '')}"
                    )
                    break
        for container in containers:
            for check in cfg.container_statuses:
                if check.matches(container, time_in_state):
                    result = max_action(result, check.action)
                    messages.append(
                        f"container {container.get('state')}/"
                        f"{container.get('reason')}"
                    )
                    break
        return result, "\n".join(messages)


class PodIssueHandler:
    """The pod-issue service loop (service/pod_issue_handler.go): walks
    non-running pods, applies the checker, and turns RETRY/FAIL actions
    into run-error reports; expires stuck-terminating pods."""

    def __init__(self, checker: PodChecker | None = None):
        self.checker = checker or PodChecker()
        self.terminating: dict[str, float] = {}  # run_id -> kill time

    def note_kill(self, run_id: str, now: float):
        self.terminating.setdefault(run_id, now)

    def note_gone(self, run_id: str):
        self.terminating.pop(run_id, None)

    def examine(self, pods: dict[str, dict], now: float) -> list[dict]:
        """Returns issue reports: {run_id, action, message, retryable}.
        Pods in phase created/pending are candidates; running pods are
        healthy by definition (the reference only checks pre-running and
        terminating states)."""
        issues = []
        for run_id, pod in pods.items():
            if pod.get("phase") not in ("created", "pending"):
                continue
            action, message = self.checker.get_action(pod, now)
            if action == Action.WAIT:
                continue
            issues.append(
                {
                    "run_id": run_id,
                    "action": action,
                    "message": message or "pod issue detected",
                    "retryable": action == Action.RETRY,
                }
            )
        # Stuck-terminating expiry: the pod was cancelled but still exists.
        expiry = self.checker.config.stuck_terminating_expiry_s
        for run_id, killed_at in list(self.terminating.items()):
            if run_id not in pods:
                self.terminating.pop(run_id, None)
                continue
            if now - killed_at > expiry:
                issues.append(
                    {
                        "run_id": run_id,
                        "action": Action.RETRY,
                        "message": f"pod stuck terminating for >{expiry}s; "
                        "force deleting",
                        "retryable": True,
                        "force_delete": True,
                    }
                )
        return issues
