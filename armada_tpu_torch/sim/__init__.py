from .simulator import ClusterSpec, Simulator, WorkloadSpec, JobTemplate, QueueSpecSim

__all__ = ["Simulator", "ClusterSpec", "WorkloadSpec", "JobTemplate", "QueueSpecSim"]
