from .jobdb import Job, JobDb, JobRun, JobState, RunState

__all__ = ["Job", "JobDb", "JobRun", "JobState", "RunState"]
