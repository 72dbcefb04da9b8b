"""Declarative e2e test suite: YAML specs of jobs + expected event sequences.

The reference's testsuite (internal/testsuite/app.go:36-82,
pkg/api/testspec.proto, testcases in testsuite/testcases/{basic,gpu,...}):
each spec declares jobs to submit and the ordered event types every job must
emit, with a timeout; an event watcher asserts the ordering. Same model:

  name: gang-basic
  timeout: 120
  queue: test-q
  jobs:
    - count: 4
      requests: {cpu: "1", memory: 1Gi}
      gang: {cardinality: 4}
  expectedEvents:
    - JobRunLeased
    - JobRunRunning
    - JobRunSucceeded
    - JobSucceeded

Specs run against any gRPC endpoint (a live cluster or a local ControlPlane).

This is the port's copy of the JAX package's testsuite/runner.py:

  python -m armada_tpu_torch.testsuite --server HOST:PORT testsuite_cases/*.yaml

`TestSuiteRunner` takes any object with ApiClient's methods, so a spec
also runs against an in-process client where `grpc` is missing (the
card's machine), from its dict (`TestSpec.from_dict`); `yaml` is needed
only where a spec file is read (`run_spec_file`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..services.grpc_api import ApiClient


@dataclass
class TestSpec:
    name: str
    queue: str
    jobs: list
    expected_events: list
    timeout: float = 120.0
    jobset: str = ""
    # Mid-test actions, e.g. {afterSeconds: 2, reprioritizeJobSet: 0}
    # (the reference's reprioritization testcases).
    actions: list = field(default_factory=list)

    @staticmethod
    def from_dict(doc: dict) -> "TestSpec":
        return TestSpec(
            name=doc.get("name", "unnamed"),
            queue=doc.get("queue", "test"),
            jobs=list(doc.get("jobs", [])),
            expected_events=list(doc.get("expectedEvents", [])),
            timeout=float(doc.get("timeout", 120.0)),
            jobset=doc.get("jobSetId", ""),
            actions=list(doc.get("actions", [])),
        )


@dataclass
class TestResult:
    name: str
    passed: bool
    reason: str = ""
    duration_s: float = 0.0
    events_by_job: dict = field(default_factory=dict)


def _expand_groups(spec: TestSpec) -> list[dict]:
    """Expand job groups, keeping per-group expected events and submit
    delays: [{jobs: [...], expected: [...], delay: s}]."""
    groups = []
    for i, item in enumerate(spec.jobs):
        count = int(item.get("count", 1))
        job = {
            "priority": item.get("priority", 0),
            "priority_class": item.get("priorityClassName", ""),
            "requests": item.get("requests", {}),
            "node_selector": item.get("nodeSelector", {}),
            "annotations": item.get("annotations", {}),
        }
        gang = item.get("gang")
        if gang:
            job["gang"] = {
                "id": gang.get("id", f"{spec.name}-gang-{i}"),
                "cardinality": int(gang.get("cardinality", count)),
            }
        groups.append(
            {
                "jobs": [dict(job) for _ in range(count)],
                "expected": list(
                    item.get("expectedEvents", spec.expected_events)
                ),
                "delay": float(item.get("submitDelaySeconds", 0.0)),
            }
        )
    return groups


class TestSuiteRunner:
    def __init__(self, client: ApiClient):
        self.client = client

    def run(self, spec: TestSpec) -> TestResult:
        started = time.time()
        jobset = spec.jobset or f"{spec.name}-{int(started)}"
        try:
            self.client.create_queue(spec.queue)
        except Exception:
            pass  # exists

        # Submit groups in declared order, honoring per-group delays (the
        # preemption cases submit the preemptor after the victim runs).
        groups = _expand_groups(spec)
        expected_by_job: dict[str, list] = {}
        observed: dict[str, list] = {}
        pending_actions = sorted(
            spec.actions, key=lambda a: float(a.get("afterSeconds", 0))
        )
        for group in groups:
            if group["delay"]:
                time.sleep(group["delay"])
            ids = self.client.submit_jobs(spec.queue, jobset, group["jobs"])
            for jid in ids:
                expected_by_job[jid] = group["expected"]
                observed[jid] = []

        deadline = started + spec.timeout
        cursor = 0
        while time.time() < deadline:
            while pending_actions and (
                time.time() - started
                >= float(pending_actions[0].get("afterSeconds", 0))
            ):
                action = pending_actions.pop(0)
                if "reprioritizeJobSet" in action:
                    self.client.reprioritize_jobs(
                        spec.queue,
                        jobset,
                        list(observed),
                        int(action["reprioritizeJobSet"]),
                    )
                elif "cancelJobSet" in action:
                    self.client.cancel_jobs(
                        spec.queue, jobset, cancel_jobset=True
                    )
            for event in self.client.watch_jobset(
                spec.queue, jobset, from_offset=cursor, watch=False
            ):
                cursor = max(cursor, event.get("offset", 0) + 1)
                jid = event.get("job_id", "")
                if jid in observed:
                    observed[jid].append(event["type"])
            if all(
                _is_subsequence(expected_by_job[jid], evs)
                for jid, evs in observed.items()
            ):
                return TestResult(
                    spec.name, True, duration_s=time.time() - started,
                    events_by_job=observed,
                )
            terminal_bad = [
                jid
                for jid, evs in observed.items()
                if any(t in ("JobErrors", "JobRunPreempted") for t in evs)
                and not _is_subsequence(expected_by_job[jid], evs)
                and "JobErrors" not in expected_by_job[jid]
                and "JobRunPreempted" not in expected_by_job[jid]
            ]
            if terminal_bad:
                return TestResult(
                    spec.name,
                    False,
                    reason=f"jobs failed unexpectedly: {terminal_bad[:5]} "
                    f"events={observed[terminal_bad[0]]}",
                    duration_s=time.time() - started,
                    events_by_job=observed,
                )
            time.sleep(0.25)
        missing = {
            jid: evs
            for jid, evs in observed.items()
            if not _is_subsequence(expected_by_job[jid], evs)
        }
        sample = next(iter(missing.items())) if missing else ("", [])
        return TestResult(
            spec.name,
            False,
            reason=f"timeout: {len(missing)} job(s) missing events; "
            f"sample {sample[0]}: got {sample[1]}, "
            f"want {expected_by_job.get(sample[0], spec.expected_events)}",
            duration_s=time.time() - started,
            events_by_job=observed,
        )


def _is_subsequence(expected: list, observed: list) -> bool:
    it = iter(observed)
    return all(any(o == e for o in it) for e in expected)


def run_spec_file(path: str, client: ApiClient) -> TestResult:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    return TestSuiteRunner(client).run(TestSpec.from_dict(doc))


def main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="armada-tpu-testsuite")
    ap.add_argument("--server", default="127.0.0.1:50051")
    ap.add_argument("specs", nargs="+")
    args = ap.parse_args(argv)
    client = ApiClient(args.server)
    failed = 0
    for path in args.specs:
        res = run_spec_file(path, client)
        status = "PASS" if res.passed else f"FAIL ({res.reason})"
        print(f"{res.name}: {status} [{res.duration_s:.1f}s]")
        failed += 0 if res.passed else 1
    return 1 if failed else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
