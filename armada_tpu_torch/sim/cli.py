"""Simulator CLI: run cluster+workload YAML specs through the real scheduler.

The cmd/simulator equivalent (its root command, cmd/simulator/cmd):

  python -m armada_tpu_torch.sim.cli --clusters clusters.yaml --workload load.yaml
      [--config scheduling.yaml] [--backend oracle] [--device cpu] [--seed 0]

Cluster YAML:                      Workload YAML:
  name: cluster-1                    queues:
  pool: default                        - name: queue-a
  nodeTemplates:                         priorityFactor: 1.0
    - count: 100                         jobTemplates:
      cpu: "32"                            - id: basic
      memory: 1024Gi                         number: 1000
                                             cpu: "1"
                                             memory: 4Gi
                                             runtimeMinimum: 60
                                             runtimeTailMean: 30

This is the port's copy of the JAX package's sim/cli.py. The simulation
solves on the kernel backend on the CUDA card unless asked for another
backend or device (`--device cpu`). `yaml` is needed only where a file
is read: `cluster_from_dict` and `workload_from_dict` build the specs
from the parsed documents.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..core.config import SchedulingConfig
from .simulator import (
    ClusterSpec,
    JobTemplate,
    NodeTemplate,
    QueueSpecSim,
    ShiftedExponential,
    Simulator,
    WorkloadSpec,
)


def _read_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def load_cluster(path: str) -> ClusterSpec:
    return cluster_from_dict(_read_yaml(path))


def cluster_from_dict(doc: dict) -> ClusterSpec:
    return ClusterSpec(
        name=doc.get("name", "cluster"),
        pool=doc.get("pool", "default"),
        node_templates=tuple(
            NodeTemplate(
                count=int(t["count"]),
                cpu=str(t.get("cpu", "32")),
                memory=str(t.get("memory", "1024Gi")),
                gpu=str(t.get("gpu", "0")),
                labels=dict(t.get("labels", {})),
            )
            for t in doc.get("nodeTemplates", [])
        ),
    )


def load_workload(path: str) -> WorkloadSpec:
    return workload_from_dict(_read_yaml(path))


def workload_from_dict(doc: dict) -> WorkloadSpec:
    queues = []
    for q in doc.get("queues", []):
        templates = []
        for t in q.get("jobTemplates", []):
            templates.append(
                JobTemplate(
                    id=str(t.get("id", "tmpl")),
                    number=int(t.get("number", 1)),
                    cpu=str(t.get("cpu", "1")),
                    memory=str(t.get("memory", "4Gi")),
                    gpu=str(t.get("gpu", "0")),
                    priority_class=t.get("priorityClassName", ""),
                    queue_priority=int(t.get("queuePriority", 0)),
                    runtime=ShiftedExponential(
                        minimum=float(t.get("runtimeMinimum", 60)),
                        tail_mean=float(t.get("runtimeTailMean", 0)),
                    ),
                    submit_time=float(t.get("submitTime", 0)),
                    gang_cardinality=int(t.get("gangCardinality", 0)),
                    node_selector=dict(t.get("nodeSelector", {})),
                )
            )
        queues.append(
            QueueSpecSim(
                q["name"], float(q.get("priorityFactor", 1.0)), tuple(templates)
            )
        )
    return WorkloadSpec(queues=tuple(queues))


def main(argv=None):
    p = argparse.ArgumentParser(prog="armada-tpu-simulator")
    p.add_argument("--clusters", nargs="+", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--config")
    p.add_argument("--backend", default="kernel", choices=["oracle", "kernel"])
    p.add_argument("--device", default="",
                   help="torch device of the kernel backend (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycle-interval", type=float, default=10.0)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    args = p.parse_args(argv)

    config = SchedulingConfig()
    if args.config:
        doc = _read_yaml(args.config) or {}
        config = SchedulingConfig.from_dict(doc.get("scheduling", doc))

    sim = Simulator(
        [load_cluster(c) for c in args.clusters],
        load_workload(args.workload),
        config,
        backend=args.backend,
        device=args.device or None,
        seed=args.seed,
        cycle_interval=args.cycle_interval,
    )
    wall0 = time.time()
    res = sim.run()
    wall = time.time() - wall0
    out = {
        "finished_jobs": res.finished_jobs,
        "total_jobs": res.total_jobs,
        "makespan_s": res.makespan,
        "preemptions": res.preemptions,
        "cycles": res.cycles,
        "wall_s": round(wall, 2),
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0 if res.finished_jobs + res.preemptions >= res.total_jobs else 1


if __name__ == "__main__":
    sys.exit(main())
