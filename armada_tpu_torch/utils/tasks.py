"""Background task manager: named periodic tasks with clean shutdown.

Port of internal/common/task/background_task.go
(BackgroundTaskManager): register(fn, interval, name) starts a loop that
sleeps `interval` between RETURNS of fn (not fixed-rate ticks), task
runtimes feed a duration metric when a registry is attached, panics are
contained per task (one bad loop must not kill its siblings), and
stop_all() joins every task with a timeout, reporting stragglers.

Replaces the ad-hoc daemon threads the services previously spawned; the
control plane registers its maintenance loops (lookout sync, retention
pruning, checkpoint + compaction) here.
"""

from __future__ import annotations

import threading
import time


class _Task:
    def __init__(self, name: str, fn, interval: float):
        self.name = name
        self.fn = fn
        self.interval = interval
        self.stop_event = threading.Event()
        self.thread: threading.Thread | None = None
        self.runs = 0
        self.failures = 0
        self.last_duration_s = 0.0


class BackgroundTaskManager:
    def __init__(self, logger=None, observe=None):
        """observe: optional callable (task_name, duration_s) feeding a
        metrics histogram (the reference's per-task latency histogram)."""
        self.logger = logger
        self.observe = observe
        self._tasks: list[_Task] = []
        self._lock = threading.Lock()

    def register(self, fn, interval: float, name: str) -> None:
        """Run fn forever, sleeping `interval` between returns (the
        reference's semantics: spacing, not a fixed rate)."""
        task = _Task(name, fn, interval)

        def loop():
            while not task.stop_event.is_set():
                started = time.monotonic()
                try:
                    task.fn()
                    task.runs += 1
                except Exception as e:  # contained: siblings keep running
                    task.failures += 1
                    if self.logger is not None:
                        self.logger.with_fields(task=task.name).error(
                            "background task failed: %r", e
                        )
                task.last_duration_s = time.monotonic() - started
                if self.observe is not None:
                    self.observe(task.name, task.last_duration_s)
                task.stop_event.wait(task.interval)

        task.thread = threading.Thread(
            target=loop, name=f"task-{name}", daemon=True
        )
        task.thread.start()
        with self._lock:
            self._tasks.append(task)

    def stop_all(self, timeout: float = 5.0) -> list[str]:
        """Stop every task; join with a shared deadline. Returns the names
        still running at the deadline ([] = clean shutdown)."""
        with self._lock:
            tasks = list(self._tasks)
        for task in tasks:
            task.stop_event.set()
        deadline = time.monotonic() + timeout
        stragglers = []
        for task in tasks:
            remaining = max(0.0, deadline - time.monotonic())
            if task.thread is not None:
                task.thread.join(timeout=remaining)
                if task.thread.is_alive():
                    stragglers.append(task.name)
        return stragglers

    def stats(self) -> dict:
        with self._lock:
            return {
                t.name: {
                    "runs": t.runs,
                    "failures": t.failures,
                    "last_duration_s": round(t.last_duration_s, 4),
                }
                for t in self._tasks
            }
