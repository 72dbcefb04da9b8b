"""Binoculars: job log access and node cordoning.

The reference runs a per-cluster aux service for these two operations
because the control plane has no kube-api access
(internal/binoculars/server.go:17, service/{logs,cordon}.go).
Here executors expose the same two capabilities through their heartbeat
connection; the control-plane service routes by node/executor. Fake
executors synthesize log lines; a real executor agent would proxy its
container runtime.
"""

from __future__ import annotations


class BinocularsService:
    def __init__(self, scheduler, executors=None):
        self.scheduler = scheduler
        # name -> executor object exposing get_logs/cordon (FakeExecutor or
        # a remote proxy).
        self.executors = {e.name: e for e in (executors or [])}

    def register(self, executor):
        self.executors[executor.name] = executor

    def get_logs(self, job_id: str, tail_lines: int = 100) -> list[str]:
        job = self.scheduler.jobdb.get(job_id)
        if job is None:
            raise KeyError(f"job {job_id} not found")
        run = job.latest_run
        if run is None:
            return []
        executor = self.executors.get(run.executor)
        if executor is None or not hasattr(executor, "get_logs"):
            raise KeyError(f"executor {run.executor!r} not reachable")
        return executor.get_logs(job_id, tail_lines)

    def set_cordon(self, node_id: str, cordoned: bool) -> bool:
        for executor in self.executors.values():
            if hasattr(executor, "cordon") and executor.cordon(node_id, cordoned):
                return True
        raise KeyError(f"node {node_id} not found on any executor")

    def cordon_node(self, node_id: str) -> bool:
        return self.set_cordon(node_id, True)

    def uncordon_node(self, node_id: str) -> bool:
        return self.set_cordon(node_id, False)
