"""Load tester: fire-hose job submission against a running control plane.

The cmd/armada-load-tester equivalent (pkg/client/load-test.go):
submits batches of jobs across queues/jobsets at a target rate, then watches
for completion and reports throughput/latency percentiles.

  python -m armada_tpu_torch.clients.load_tester --server HOST:PORT \
      --queues 5 --jobs 1000 --batch 100 [--cpu 1] [--watch]

This is the port's copy of the JAX package's clients/load_tester.py. It
reaches the server through `services.grpc_api.connect`, which needs
`grpc`; a caller without it (the card's machine) binds this module's
`connect` to an in-process client with ApiClient's methods.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..services.grpc_api import connect


def percentile(values, p):
    if not values:
        return 0.0
    values = sorted(values)
    idx = min(len(values) - 1, int(p / 100 * len(values)))
    return values[idx]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="armada-tpu-load-tester")
    ap.add_argument("--server", default="127.0.0.1:50051")
    ap.add_argument("--queues", type=int, default=5)
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--cpu", default="1")
    ap.add_argument("--memory", default="1Gi")
    ap.add_argument("--watch", action="store_true", help="wait for completion")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    client = connect(args.server)
    for i in range(args.queues):
        try:
            client.create_queue(f"load-{i:03d}")
        except Exception:
            pass  # exists

    job = {"requests": {"cpu": args.cpu, "memory": args.memory}}
    submitted = []
    submit_latencies = []
    t0 = time.time()
    n = 0
    while n < args.jobs:
        batch = min(args.batch, args.jobs - n)
        queue = f"load-{n % args.queues:03d}"
        t = time.time()
        ids = client.submit_jobs(queue, f"load-set-{n % args.queues}", [dict(job) for _ in range(batch)])
        submit_latencies.append(time.time() - t)
        submitted += [(queue, jid) for jid in ids]
        n += batch
    submit_wall = time.time() - t0

    report = {
        "submitted": len(submitted),
        "submit_wall_s": round(submit_wall, 3),
        "submit_jobs_per_s": round(len(submitted) / submit_wall, 1),
        "submit_batch_p50_ms": round(percentile(submit_latencies, 50) * 1000, 1),
        "submit_batch_p99_ms": round(percentile(submit_latencies, 99) * 1000, 1),
    }

    if args.watch:
        deadline = time.time() + args.timeout
        done = 0
        while time.time() < deadline:
            done = 0
            for i in range(args.queues):
                groups = client.group_jobs(
                    "state", filters=[{"field": "queue", "value": f"load-{i:03d}"}]
                )
                done += sum(
                    g["count"]
                    for g in groups
                    if g["name"] in ("succeeded", "failed", "cancelled", "preempted")
                )
            if done >= len(submitted):
                break
            time.sleep(1.0)
        report["completed"] = done
        report["complete_wall_s"] = round(time.time() - t0, 1)
        if report["complete_wall_s"] > 0:
            report["throughput_jobs_per_s"] = round(done / report["complete_wall_s"], 1)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
