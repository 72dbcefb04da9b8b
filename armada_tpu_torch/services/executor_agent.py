"""Remote executor agent: a separate process speaking the lease protocol.

The reference's executor (internal/executor/application.go) is an agent per
worker cluster: it reports node state, receives leases over the
ExecutorApi stream, creates pods, and reports their lifecycle. This agent
is the same loop over the gRPC ExecutorLease/ReportEvents methods, with a
simulated pod runtime (the fake cluster context) — swap `_PodRuntime` for a
real container backend to manage actual machines.

  python -m armada_tpu_torch.services.executor_agent \
      --server HOST:PORT --name clusterA --nodes 100 --cpu 8 [--pool p]

This is the port's copy of the JAX package's services/executor_agent.py.
`ExecutorAgent` takes any client with `_call(method, request)`; the CLI
above connects with the gRPC ApiClient (or ProtoExecutorClient), so it
needs `grpc` (and `google.protobuf` for `--wire proto`). In process, an
agent leases through the ApiServer's method table over the JSON codec
with neither.
"""

from __future__ import annotations

import argparse
import time

from .grpc_api import ApiClient
from .podchecks import PodIssueHandler
from .utilisation import UtilisationReporter, node_reports


class ServiceRegistry:
    """Services/ingresses the executor creates alongside pods
    (executor/job/submit.go:110-140: SubmitService/SubmitIngress with an
    owner reference to the pod, so the objects share its lifecycle).
    Both pod runtimes attach one; records die with their owning pod —
    the owner-reference garbage collection analogue."""

    def __init__(self):
        self.services: dict[str, list[dict]] = {}  # run_id -> records
        self.ingresses: dict[str, list[dict]] = {}

    def create_for(self, lease: dict) -> None:
        spec = lease.get("spec") or {}
        run_id = lease["run_id"]
        job_id = lease.get("job_id", "")
        for n, svc in enumerate(spec.get("services") or ()):
            self.services.setdefault(run_id, []).append(
                {
                    "name": f"armada-{job_id}-{n}-{svc.get('type', 'NodePort').lower()}",
                    "owner_run": run_id,
                    "type": svc.get("type", "NodePort"),
                    "ports": list(svc.get("ports", ())),
                }
            )
        for n, ing in enumerate(spec.get("ingresses") or ()):
            self.ingresses.setdefault(run_id, []).append(
                {
                    "name": f"armada-{job_id}-{n}-ingress",
                    "owner_run": run_id,
                    "ports": list(ing.get("ports", ())),
                    "annotations": dict(
                        tuple(kv) for kv in ing.get("annotations", ())
                    ),
                    "tls_enabled": bool(ing.get("tls_enabled", False)),
                }
            )

    def collect(self, run_id: str) -> None:
        """Owner pod gone: its objects are garbage-collected."""
        self.services.pop(run_id, None)
        self.ingresses.pop(run_id, None)


class _PodRuntime:
    """Simulated pods: timed sleeps, like the reference fake executor."""

    def __init__(self, runtime_s: float = 30.0, startup_s: float = 0.0):
        self.runtime_s = runtime_s
        self.startup_s = startup_s
        self.pods: dict[str, dict] = {}  # run_id -> pod record
        self.objects = ServiceRegistry()

    def create(self, lease: dict, now: float):
        self.pods[lease["run_id"]] = {
            **lease,
            "created": now,
            "last_change": now,
            "node": lease.get("node_id", ""),
            "phase": "created",
        }
        self.objects.create_for(lease)

    def _remove(self, run_id: str):
        """The ONLY way a pod record leaves the runtime: owner-referenced
        objects are garbage-collected with it, structurally."""
        pod = self.pods.pop(run_id, None)
        self.objects.collect(run_id)
        return pod

    def kill(self, run_id: str):
        self._remove(run_id)

    def poll(self, now: float) -> list[dict]:
        """Phase transitions since last poll, as ReportEvents items."""
        events = []
        for pod in list(self.pods.values()):
            base = {
                "job_id": pod["job_id"],
                "run_id": pod["run_id"],
                "queue": pod["queue"],
                "jobset": pod["jobset"],
                "created": now,
                # Echo the lease's trace context so the run's lifecycle
                # reports join the job's submit trace.
                "traceparent": pod.get("traceparent", ""),
            }
            if pod["phase"] == "created":
                events.append({"type": "pending", **base})
                pod["phase"] = "pending"
            elif pod["phase"] == "pending" and now >= pod["created"] + self.startup_s:
                events.append({"type": "running", **base})
                pod["phase"] = "running"
                pod["started"] = now
            elif (
                pod["phase"] == "running"
                and now >= pod["started"] + self.runtime_s
            ):
                events.append({"type": "succeeded", **base})
                self._remove(pod["run_id"])
        return events


class SubprocessPodRuntime:
    """REAL pods: each lease becomes an OS process (the cluster-context
    seam proven end-to-end without Kubernetes — submit.go creates pods,
    here Popen creates processes). The job spec's `command` argv runs with
    an address-space rlimit derived from its memory request (resource
    accounting enforced by the kernel, not simulated); empty commands fall
    back to a sleep of `default_runtime_s`. Phases map as
    created -> pending (spawn) -> running -> succeeded/failed(rc), with rc
    and rusage in the failure debug dump."""

    def __init__(self, default_runtime_s: float = 30.0, enforce_rlimits: bool = True):
        self.default_runtime_s = default_runtime_s
        self.enforce_rlimits = enforce_rlimits
        self.pods: dict[str, dict] = {}  # run_id -> pod record
        self.objects = ServiceRegistry()

    def create(self, lease: dict, now: float):
        self.pods[lease["run_id"]] = {
            **lease,
            "created": now,
            "last_change": now,
            "node": lease.get("node_id", ""),
            "phase": "created",
            "proc": None,
            "stderr": None,
        }
        self.objects.create_for(lease)

    def _spawn(self, pod: dict):
        import subprocess

        spec = pod.get("spec") or {}
        argv = list(spec.get("command") or ())
        if not argv:
            argv = ["/bin/sh", "-c", f"sleep {self.default_runtime_s}"]
        limit_bytes = None
        if self.enforce_rlimits:
            mem = (spec.get("requests") or {}).get("memory")
            if mem:
                from ..core.resources import parse_quantity

                limit_bytes = int(parse_quantity(mem))

        if limit_bytes:
            # The memory rlimit is applied by a shell wrapper between fork
            # and the job's exec — NOT preexec_fn: this process is
            # multithreaded (gRPC client threads, task manager, JAX), and
            # running Python between fork and exec is documented
            # deadlock-prone there. `ulimit -v` takes KiB.
            kib = max(1, limit_bytes // 1024)
            import shlex

            # `|| exit 127`: a failed ulimit (hard limit already lower, or
            # a shell without -v) must fail the pod visibly, not exec the
            # job uncapped — matching the old preexec_fn abort semantics.
            argv = [
                "/bin/sh",
                "-c",
                f"ulimit -v {kib} || exit 127; exec "
                + " ".join(shlex.quote(a) for a in argv),
            ]

        # stderr spools to an unnamed temp file, not a PIPE: a chatty job
        # writing past the pipe buffer would block in write(2) forever with
        # nobody draining it. The file is unbounded, kernel-backed, and
        # read only at failure time.
        import tempfile

        stderr = tempfile.TemporaryFile()
        try:
            return subprocess.Popen(
                argv,
                stdout=subprocess.DEVNULL,
                stderr=stderr,
                start_new_session=True,  # kill() takes the process group
            ), stderr
        except OSError:
            stderr.close()
            raise

    def _remove(self, run_id: str):
        """Sole removal path: closes the stderr spool and garbage-collects
        the pod's owner-referenced objects."""
        pod = self.pods.pop(run_id, None)
        self.objects.collect(run_id)
        if pod and pod.get("stderr") is not None:
            pod["stderr"].close()
        return pod

    def kill(self, run_id: str):
        pod = self._remove(run_id)
        if pod and pod.get("proc") is not None:
            import os as _os
            import signal

            try:
                _os.killpg(pod["proc"].pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            pod["proc"].wait()

    def poll(self, now: float) -> list[dict]:
        events = []
        for pod in list(self.pods.values()):
            base = {
                "job_id": pod["job_id"],
                "run_id": pod["run_id"],
                "queue": pod["queue"],
                "jobset": pod["jobset"],
                "created": now,
                "traceparent": pod.get("traceparent", ""),
            }
            if pod["phase"] == "created":
                try:
                    pod["proc"], pod["stderr"] = self._spawn(pod)
                except OSError as e:
                    events.append(
                        {
                            "type": "failed",
                            **base,
                            "error": f"pod create failed: {e}",
                            "retryable": True,
                            "debug": _pod_debug(pod, now),
                        }
                    )
                    self._remove(pod["run_id"])
                    continue
                pod["phase"] = "pending"
                events.append({"type": "pending", **base})
            elif pod["phase"] == "pending":
                pod["phase"] = "running"
                pod["started"] = now
                events.append({"type": "running", **base})
            elif pod["phase"] == "running":
                rc = pod["proc"].poll()
                if rc is None:
                    continue
                if rc == 0:
                    events.append({"type": "succeeded", **base})
                else:
                    stderr = b""
                    f = pod.get("stderr")
                    if f is not None:
                        size = f.seek(0, 2)
                        f.seek(max(0, size - 500))
                        stderr = f.read() or b""
                    events.append(
                        {
                            "type": "failed",
                            **base,
                            "error": (
                                f"process exited rc={rc}: "
                                f"{stderr.decode(errors='replace')}"
                            ),
                            "retryable": True,
                            "debug": _pod_debug({**pod, "rc": rc}, now),
                        }
                    )
                self._remove(pod["run_id"])
        return events


def _pod_debug(pod: dict, now: float) -> str:
    """Human-readable pod state at failure time — the executor-side dump
    the reference compresses into lookout's job_run.debug column."""
    import json as _json

    dump = {
        "phase": pod.get("phase", ""),
        "node": pod.get("node", ""),
        "created": pod.get("created"),
        "started": pod.get("started"),
        "age_s": round(now - pod.get("created", now), 3),
        "last_change_age_s": round(now - pod.get("last_change", now), 3),
    }
    if "rc" in pod:
        dump["rc"] = pod["rc"]
    return _json.dumps(dump, sort_keys=True)


class ExecutorAgent:
    def __init__(
        self,
        client: ApiClient,
        name: str,
        nodes: list[dict],
        pool: str = "default",
        runtime: _PodRuntime | None = None,
        node_info=None,
        fault_plan=None,
        backoff=None,
        lease_ttl_s: float | None = None,
    ):
        self.client = client
        self.name = name
        self.pool = pool
        # Deterministic fault injection (services/chaos.py) + the retry
        # backoff the injected faults are met with in run().
        self.fault_plan = fault_plan
        self.backoff = backoff
        self._crashed = False
        # Partition safety (split-brain model, docs/architecture.md):
        # lease TTL (None = adopt the server-advertised value from the
        # first lease reply; 0 disables), the monotonic fencing token
        # echoed on every exchange, the instant of the last SUCCESSFUL
        # exchange, and the pods flagged as orphan candidates once the
        # lease expired — kept running (the server may not have expired
        # us yet) but reconciled through ExecutorSync before this agent
        # accepts new work.
        self.lease_ttl_s = lease_ttl_s
        self.fence_token = 0
        self.last_exchange_ok: float | None = None
        self.orphan_candidates: set[str] = set()
        self.syncs = 0  # completed anti-entropy syncs (observability)
        # Node classification (executor/node/node_group.go): derive each
        # node's pool (label + reserved suffix) and node type up front so
        # heartbeats carry them.
        from .node_info import NodeInfoService

        self.node_info = node_info or NodeInfoService(cluster_pool=pool)
        self.nodes = self.node_info.decorate(nodes)
        self.runtime = runtime or _PodRuntime()
        self.acked: set[str] = set()
        # Pod-issue machinery + utilisation reporting (executor/podchecks,
        # executor/utilisation): stuck pods are actioned into retry/fail
        # reports; node heartbeats carry usage and the non-framework slice.
        self.issue_handler = PodIssueHandler()
        self.utilisation = UtilisationReporter()
        self.non_framework_usage: dict[str, dict] = {}
        # Runs whose terminal event we already sent but the server still
        # lists as active (its ingest lags the report by a cycle): the
        # reconciliation sweep must not re-report them as missing pods —
        # that would overwrite the real terminal reason.
        self._reported_terminal: set[str] = set()

    def _inject_faults(self, now: float) -> None:
        """Apply the fault plan before the lease exchange; raises to
        simulate the failure (run()'s backoff loop absorbs it)."""
        plan = self.fault_plan
        if plan is None:
            return
        if plan.active("executor_crash", self.name, now) is not None:
            if not self._crashed:
                for run_id in list(self.runtime.pods):
                    self.runtime.kill(run_id)
                self.acked.clear()
                self._reported_terminal.clear()
                self._crashed = True
            raise RuntimeError("executor crashed (injected fault)")
        self._crashed = False
        if plan.active("executor_hang", self.name, now) is not None:
            raise RuntimeError("executor hung (injected fault)")
        if plan.active("network_partition", self.name, now) is not None:
            # Socketless image of the netchaos sever: the exchange fails
            # exactly like a proxied connection torn mid-RPC. Pods keep
            # running — only the wire is gone.
            raise ConnectionError("network partitioned (injected fault)")
        if plan.active("lease_timeout", self.name, now) is not None:
            raise TimeoutError("lease RPC timed out (injected fault)")
        slow = plan.active("lease_slow", self.name, now)
        if slow is not None and slow.param > 0:
            time.sleep(min(slow.param, 5.0))

    def lease_expired(self, now: float) -> bool:
        """True once no lease exchange has completed within lease_ttl:
        this agent must assume the scheduler has (or soon will have)
        reassigned its runs."""
        ttl = self.lease_ttl_s
        if not ttl or self.last_exchange_ok is None:
            return False
        return now - self.last_exchange_ok > ttl

    def mark_orphan_candidates(self) -> None:
        """Lease expired mid-partition: every running pod may already
        have been requeued server-side. They keep running (killing work
        the server may still own would waste it) but are flagged for the
        anti-entropy sync, and no NEW leases are accepted until it
        completes."""
        if not self.orphan_candidates:
            self.orphan_candidates = set(self.runtime.pods)

    def resync(self, now: float) -> dict:
        """Anti-entropy full-state sync (ExecutorSync): report every pod
        actually held, tear down the ones the server classified zombie or
        duplicate, adopt the current fence token. The one way back into
        the lease flow after a fence bump or an expired lease."""
        runs = [
            {
                "run_id": rid,
                "job_id": pod.get("job_id", ""),
                "phase": pod.get("phase", ""),
            }
            for rid, pod in self.runtime.pods.items()
        ]
        reply = self.client._call(
            "ExecutorSync", {"executor": self.name, "runs": runs}
        )
        for kill in reply.get("kill_runs", []):
            self.issue_handler.note_kill(kill["run_id"], now)
            self.runtime.kill(kill["run_id"])
            self.issue_handler.note_gone(kill["run_id"])
        self.fence_token = int(reply.get("fence_token", 0) or 0)
        self.orphan_candidates.clear()
        self.acked &= set(self.runtime.pods)
        # Runs the sync's orphan sweep already failed server-side must
        # not be re-reported by the missing-pod reconciliation below.
        self._reported_terminal |= set(reply.get("orphaned_run_ids", ()))
        self.syncs += 1
        return reply

    def tick(self, now: float | None = None) -> dict:
        """One agent heartbeat, traced: the tick span's context rides the
        lease/report RPC metadata (ApiClient injects `traceparent`), so
        the server can stitch executor exchanges into cross-process
        traces."""
        now = time.time() if now is None else now
        from ..utils.tracing import TRACER

        with TRACER.span("executor.tick", executor=self.name):
            return self._tick(now)

    def _tick(self, now: float) -> dict:
        self._inject_faults(now)
        was_expired = self.lease_expired(now)
        if was_expired:
            self.mark_orphan_candidates()
        self.utilisation.sample(self.runtime.pods)
        lease_req = {
            "executor": self.name,
            "pool": self.pool,
            "nodes": node_reports(
                self.nodes,
                self.utilisation.by_node(),
                self.non_framework_usage,
            ),
            "acked_run_ids": sorted(self.acked),
            "fence_token": self.fence_token,
        }
        from .grpc_api import is_fenced_error

        synced_this_tick = False
        try:
            reply = self.client._call("ExecutorLease", lease_req)
        except Exception as e:
            if not is_fenced_error(e):
                raise
            # The scheduler reassigned our runs while we were gone: run
            # the anti-entropy sync, then retry the exchange once with
            # the fresh token.
            self.resync(now)
            synced_this_tick = True
            was_expired = True  # stale state: defer new leases this tick
            lease_req["fence_token"] = self.fence_token
            reply = self.client._call("ExecutorLease", lease_req)
        if was_expired and not synced_this_tick:
            # Healed before the server expired us (no fence rejection):
            # reconcile anyway — the lease outlived its TTL, so local and
            # server state may have diverged.
            self.resync(now)
        # Monotonic: never step a fresher token (e.g. one just adopted
        # from a sync) back to an older reply's view.
        self.fence_token = max(
            self.fence_token, int(reply.get("fence_token", 0) or 0)
        )
        if self.lease_ttl_s is None:
            self.lease_ttl_s = float(reply.get("lease_ttl_s", 0.0) or 0.0)
        self.last_exchange_ok = now
        # Store backpressure (the reference pauses pod creation while etcd
        # is over capacity, executor/application.go:63-101): defer NEW
        # leases while the server reports the store unhealthy — they stay
        # unacked and are re-sent once it recovers. Running pods continue.
        # An expired lease defers identically: new work waits for the
        # anti-entropy sync to finish and the next clean exchange.
        if reply.get("store_healthy", True) and not was_expired:
            for lease in reply.get("leases", []):
                if lease["run_id"] not in self.acked:
                    from ..utils.compress import decompress_obj

                    lease = {**lease, "spec": decompress_obj(lease.get("spec"))}
                    # create before ack: a failed create must be re-leased
                    self.runtime.create(lease, now)
                    self.acked.add(lease["run_id"])
        for cancel in reply.get("cancel_runs", []):
            self.issue_handler.note_kill(cancel["run_id"], now)
            self.runtime.kill(cancel["run_id"])
            self.issue_handler.note_gone(cancel["run_id"])
        events = self.runtime.poll(now)
        # Pod-issue sweep: stuck pods become retryable/fatal run errors
        # (service/pod_issue_handler.go).
        for issue in self.issue_handler.examine(self.runtime.pods, now):
            pod = self.runtime.pods.get(issue["run_id"])
            if pod is None:
                continue
            events.append(
                {
                    "type": "failed",
                    "job_id": pod["job_id"],
                    "run_id": pod["run_id"],
                    "queue": pod["queue"],
                    "jobset": pod["jobset"],
                    "created": now,
                    "error": f"pod issue: {issue['message']}",
                    "retryable": issue["retryable"],
                    "traceparent": pod.get("traceparent", ""),
                    # Pod-state dump for the lookout debug drilldown
                    # (job_run.debug, getjobrundebugmessage.go).
                    "debug": _pod_debug(pod, now),
                }
            )
            self.runtime.kill(issue["run_id"])
        # Reconciliation: runs the server believes are live here but the
        # runtime doesn't know (agent restart, lost pod) are reported
        # failed so the scheduler retries them elsewhere (the reference
        # executor's missing-pod reconciliation). A run whose pod already
        # produced its terminal event — this tick OR a recent one the
        # server hasn't ingested yet (active_runs lags by a cycle) — must
        # not be re-reported as missing: that would overwrite the real
        # terminal reason.
        reported = {
            e["run_id"] for e in events if e["type"] in ("failed", "succeeded")
        }
        active_ids = {r["run_id"] for r in reply.get("active_runs", [])}
        # Entries leave the set once the server stops listing the run
        # (ingest caught up), so the set stays bounded. This tick's
        # terminal reports join only AFTER ReportEvents succeeds below —
        # a failed send must leave the run eligible for missing-pod
        # reconciliation (the event was lost; reconciliation is the
        # retry path). (A server with an open lease circuit fails the RPC
        # above — a degraded reply can never reach this bookkeeping.)
        self._reported_terminal &= active_ids
        for run in reply.get("active_runs", []):
            if (
                run["run_id"] not in self.runtime.pods
                and run["run_id"] not in reported
                and run["run_id"] not in self._reported_terminal
            ):
                events.append(
                    {
                        "type": "failed",
                        "job_id": run["job_id"],
                        "run_id": run["run_id"],
                        "queue": run["queue"],
                        "jobset": run["jobset"],
                        "created": now,
                        "error": "pod missing on executor (restart or loss)",
                        "retryable": True,
                    }
                )
        if events:
            self.client._call(
                "ReportEvents",
                {
                    "events": events,
                    # Fenced like the lease path: if the scheduler bumped
                    # our fence between the exchange above and this send,
                    # the report fails FAILED_PRECONDITION and the next
                    # tick's sync resolves the runs instead.
                    "executor": self.name,
                    "fence_token": self.fence_token,
                },
            )
            # The send landed: suppress reconciliation for these runs
            # until the server's view catches up.
            self._reported_terminal |= reported
        # Prune acks for pods that no longer exist: completed runs don't
        # need acks (the server only re-sends LEASED runs), and the set
        # must not grow forever.
        self.acked &= set(self.runtime.pods)
        return reply

    def run(self, interval: float = 1.0):
        """The agent loop: retry with exponential backoff + jitter on any
        tick failure (control-plane hiccup, injected fault), reset on the
        first success — transient faults cost one delayed tick, sustained
        ones back off toward the cap instead of hammering the server.

        The backoff's cumulative sleep is budgeted at lease_ttl: a
        retrying exchange must never sleep past the lease it is renewing.
        Once the budget is spent the lease is presumed dead — running
        pods become orphan candidates, new work is refused, and retries
        poll flat so the heal is noticed promptly and resolved through
        the anti-entropy sync."""
        import zlib

        from .chaos import ExponentialBackoff

        # Seeded per executor: a fleet-wide outage must NOT synchronize
        # every agent's retry instants (decorrelated jitter).
        backoff = self.backoff or ExponentialBackoff(
            base_s=max(interval, 0.1),
            cap_s=60.0,
            seed=zlib.crc32(self.name.encode()),
            budget_s=self.lease_ttl_s,
        )
        while True:
            try:
                self.tick()
            except Exception as e:  # control plane hiccup: back off + retry
                if backoff.budget_s is None and self.lease_ttl_s:
                    # TTL adopted from the server after the backoff was
                    # built: arm the budget now.
                    backoff.budget_s = self.lease_ttl_s
                now = time.time()
                if backoff.exhausted or self.lease_expired(now):
                    self.mark_orphan_candidates()
                delay = backoff.next_delay()
                print(
                    f"executor {self.name}: tick failed: {e!r}; "
                    f"retrying in {delay:.1f}s (attempt {backoff.attempt})"
                )
                time.sleep(delay)
                continue
            backoff.reset()
            time.sleep(interval)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="armada-tpu-executor")
    ap.add_argument("--server", default="127.0.0.1:50051")
    ap.add_argument("--name", required=True)
    ap.add_argument("--pool", default="default")
    ap.add_argument("--nodes", type=int, default=10)
    ap.add_argument("--cpu", default="8")
    ap.add_argument("--memory", default="128Gi")
    ap.add_argument("--runtime", type=float, default=30.0)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument(
        "--lease-ttl",
        type=float,
        default=-1.0,
        help="lease TTL seconds: no successful exchange for this long "
        "marks running pods orphan candidates and defers new work until "
        "an anti-entropy sync; -1 adopts the server-advertised value, "
        "0 disables",
    )
    ap.add_argument(
        "--backend",
        choices=["simulated", "subprocess"],
        default="simulated",
        help="pod runtime: timed sleeps, or real OS processes running "
        "each job's command with rlimit enforcement",
    )
    ap.add_argument(
        "--wire",
        choices=["json", "proto"],
        default="json",
        help="lease-exchange encoding: JSON, or the binary protobuf wire "
        "(proto/armada.proto LeaseRequest/LeaseResponse)",
    )
    ap.add_argument("--ca-cert", default="",
                    help="CA bundle: connect with TLS")
    ap.add_argument("--token", default="",
                    help="Bearer token for the server's auth chain")
    args = ap.parse_args(argv)
    nodes = [
        {
            "id": f"{args.name}-node-{i:05d}",
            "total_resources": {"cpu": args.cpu, "memory": args.memory},
        }
        for i in range(args.nodes)
    ]
    runtime = (
        SubprocessPodRuntime(default_runtime_s=args.runtime)
        if args.backend == "subprocess"
        else _PodRuntime(runtime_s=args.runtime)
    )
    if args.wire == "proto":
        from .grpc_api import ProtoExecutorClient as client_cls
    else:
        client_cls = ApiClient
    client = client_cls(
        args.server, token=args.token or None, ca_cert=args.ca_cert or None
    )
    agent = ExecutorAgent(
        client,
        args.name,
        nodes,
        pool=args.pool,
        runtime=runtime,
        lease_ttl_s=None if args.lease_ttl < 0 else args.lease_ttl,
    )
    agent.run(args.interval)


if __name__ == "__main__":
    main()
