from .scheduler import ExecutorHeartbeat, SchedulerService
from .submit import SubmitService

__all__ = ["SchedulerService", "ExecutorHeartbeat", "SubmitService"]
