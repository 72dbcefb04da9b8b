"""armadactl-equivalent CLI.

Command surface mirrors internal/armadactl: queue CRUD and
cordon, submit (YAML job files), cancel, reprioritize, watch, job queries,
scheduling reports, per-job journey traces (`job-trace`), SLO status
(`slo`), the fairness scorecard (`fairness`), plus `server` to run a
local control plane.

  python -m armada_tpu_torch.clients.cli --server 127.0.0.1:50051 <command> ...

This is the port's copy of the JAX package's clients/cli.py. It needs
`grpc` only where `connect` opens a channel and `yaml` only where a job
file or a config file is read, so on a machine with neither (the card's)
it runs over an in-process client bound to this module's `connect`.
`server` runs the port's ControlPlane on the kernel backend on the CUDA
card unless asked for another device (`--device cpu`); `policy ab`
replays on `--device` the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..services.grpc_api import connect


def _print(obj):
    print(json.dumps(obj, indent=2, default=str))


def cmd_queue(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    cordoned = True if args.cordon else (False if args.uncordon else None)
    if args.action == "create":
        client.create_queue(
            args.name, args.priority_factor or 1.0, bool(cordoned)
        )
        print(f"created queue {args.name}")
    elif args.action == "update":
        client.update_queue(args.name, args.priority_factor, cordoned)
        print(f"updated queue {args.name}")
    elif args.action == "delete":
        client.delete_queue(args.name)
        print(f"deleted queue {args.name}")
    elif args.action == "get":
        _print(client.get_queue(args.name))
    elif args.action == "list":
        _print(client.list_queues())


def _jobs_from_yaml(path: str) -> tuple[str, str, list[dict]]:
    """Job-file format mirrors armadactl submit yaml: queue, jobSetId, jobs:
    [{priority, priorityClassName, podSpec-ish requests, ...}]."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    queue = doc.get("queue", "")
    jobset = doc.get("jobSetId", doc.get("jobset", ""))
    jobs = []
    for item in doc.get("jobs", []):
        job = {
            "priority": item.get("priority", 0),
            "priority_class": item.get("priorityClassName", ""),
            "requests": item.get("requests", {}),
            "node_selector": item.get("nodeSelector", {}),
            "annotations": item.get("annotations", {}),
            "tolerations": item.get("tolerations", []),
            # podSpec containers[0].command+args equivalent: a real argv
            # for subprocess-backed executors.
            "command": item.get("command", []),
            # armadactl job yaml services/ingress sections.
            "services": [
                {"type": s.get("type", "NodePort"),
                 "ports": s.get("ports") or []}
                for s in item.get("services") or []
            ],
            "ingresses": [
                {"ports": i.get("ports") or [],
                 "annotations": sorted(
                     (i.get("annotations") or {}).items()
                 ),
                 "tls_enabled": bool(i.get("tls", False))}
                for i in item.get("ingress") or item.get("ingresses") or []
            ],
        }
        count = int(item.get("count", 1))
        gang = item.get("gang")
        if gang:
            job["gang"] = {
                "id": gang.get("id", "gang"),
                "cardinality": gang.get("cardinality", count),
                "node_uniformity_label": gang.get("nodeUniformityLabel", ""),
            }
        jobs.extend([dict(job) for _ in range(count)])
    return queue, jobset, jobs


def cmd_submit(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    queue, jobset, jobs = _jobs_from_yaml(args.file)
    queue = args.queue or queue
    jobset = args.jobset or jobset
    ids = client.submit_jobs(queue, jobset, jobs)
    for jid in ids:
        print(jid)


def cmd_cancel(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    client.cancel_jobs(
        args.queue,
        args.jobset,
        job_ids=[args.job_id] if args.job_id else (),
        cancel_jobset=args.job_id is None,
    )
    print("cancelled")


def cmd_reprioritize(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    client.reprioritize_jobs(args.queue, args.jobset, [args.job_id], args.priority)
    print("reprioritized")


def cmd_watch(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    for event in client.watch_jobset(args.queue, args.jobset, watch=not args.no_follow):
        print(json.dumps(event, default=str))


def cmd_jobs(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    filters = []
    if args.queue:
        filters.append({"field": "queue", "value": args.queue})
    if args.state:
        filters.append({"field": "state", "value": args.state})
    _print(client.get_jobs(filters=filters, take=args.take))


def cmd_logs(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    for line in client.get_job_logs(args.job_id, args.tail):
        print(line)


def cmd_cordon(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    client.cordon_node(args.node_id, uncordon=args.action == "uncordon")
    print(f"{args.action}ed {args.node_id}")


def cmd_cordon_executor(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    client.cordon_executor(args.name, uncordon=args.action == "uncordon")
    print(f"{args.action}ed executor {args.name}")


def cmd_report(args):
    client = connect(args.server, ca_cert=args.ca_cert or None)
    if args.kind == "scheduling":
        print(client.scheduling_report())
    elif args.kind == "queue":
        print(client.queue_report(args.name))
    elif args.kind == "job":
        print(client.job_report(args.name))


def cmd_job_trace(args):
    """Print one job's end-to-end journey: submit, every round it was
    unschedulable (aggregated by reason), lease, run lifecycle — with
    the trace id the submit RPC carried (services/job_timeline.py)."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    trace = client.job_trace(args.job_id)
    if args.json:
        _print(trace["journey"])
    else:
        print(trace["rendered"])


def cmd_slo(args):
    """Print the declared SLOs with compliance and multi-window burn
    rates (services/slo.py; GET /api/slo serves the same document)."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    status = client.slo_status()
    if args.json:
        _print(status)
        return
    for s in status.get("slos", []):
        compliance = s.get("compliance")
        fast, slow = s["burn"]["fast"], s["burn"]["slow"]
        # Live state comes from the CURRENT burn windows; a historical
        # multiwindow alert renders as a suffix, not a latched state —
        # a long-lived control plane recovers in this view (the gate's
        # breach memory lives in evaluate(), where it belongs).
        state = "ALERTING" if s.get("alerting") else "ok"
        history = (
            f"  (burn alert fired at t={s['breached_at']:.1f})"
            if s.get("breached_at") is not None and not s.get("alerting")
            else ""
        )
        print(
            f"{s['name']}: {state}  "
            f"objective {s['objective']:.3f} on {s['signal']} <= "
            f"{s['threshold_s']}s  "
            + (
                f"compliance {compliance:.4f} "
                if compliance is not None
                else "compliance - "
            )
            + f"({s['good']}/{s['observed']} good)  burn "
            f"fast {fast['rate']:.2f}x/{fast['threshold']:.0f}x "
            f"slow {slow['rate']:.2f}x/{slow['threshold']:.0f}x"
            + history
        )


def cmd_doctor(args):
    """Print the self-healing solve path's state: failover ladder rung
    breaker states, recent admission-firewall rejections with their
    quarantine bundle paths, recent failovers (scheduler.doctor_report;
    GET /api/doctor serves the same)."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    doc = client.doctor()
    if args.json:
        _print(doc)
        return
    print(
        f"cycle {doc.get('cycle', 0)}  "
        f"validation {'on' if doc.get('validation_enabled') else 'OFF'}  "
        f"failover {'on' if doc.get('failover_enabled') else 'OFF'}"
    )
    for row in doc.get("ladder", []):
        mark = " (terminal)" if row.get("terminal") else ""
        fails = row.get("consecutive_failures", 0)
        tail = f"  {fails} consecutive failures" if fails else ""
        print(f"  rung {row['rung']}: {row['state']}{tail}{mark}")
    rejections = doc.get("rejections") or []
    if rejections:
        print("recent rejections:")
        for r in rejections:
            bundle = r.get("bundle") or "(postmortem not captured)"
            print(
                f"  cycle {r['cycle']} pool {r['pool']} rung {r['rung']}: "
                f"{r['invariant']} — {r['detail']}\n    postmortem: {bundle}"
            )
    else:
        print("no recent rejections")
    failovers = doc.get("failovers") or []
    if failovers:
        print("recent failovers:")
        for f in failovers:
            print(
                f"  cycle {f['cycle']} pool {f['pool']}: "
                f"{f['from']} -> {f['to']} ({f['cause']})"
            )
    else:
        print("no recent failovers")


def cmd_fairness(args):
    """Print the fairness observatory's latest per-pool scorecard:
    entitlement vs delivered share per queue, regret, Jain index,
    preemption attribution and active starvation alerts
    (observe/fairness.py; GET /api/fairness serves the same)."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    doc = client.fairness_report(pool=args.pool or None)
    if args.json:
        _print(doc)
        return
    pools = doc.get("pools") or {}
    if not pools:
        print("no fairness ledger recorded yet (no round has solved)")
        return
    for pool in sorted(pools):
        pdoc = pools[pool] or {}
        ledger = pdoc.get("ledger") or {}
        policy = pdoc.get("policy") or ledger.get("policy") or "drf"
        print(
            f"pool {pool}: policy {policy}  "
            f"jain {ledger.get('jain', 1.0):.4f}  "
            f"max regret {ledger.get('max_regret', 0.0):.4f}  "
            f"round {pdoc.get('rounds', 0)}"
        )
        for row in ledger.get("queues", []):
            flags = ""
            if row.get("alerting"):
                flags = "  STARVATION ALERT"
            elif row.get("starved"):
                flags = "  starved"
            print(
                f"  queue {row['queue']}: weight {row.get('weight', 0):g}  "
                f"share {row.get('fair_share', 0.0):.4f}  "
                f"entitled {row.get('entitlement', 0.0):.4f} "
                f"(uncapped {row.get('uncapped', 0.0):.4f})  "
                f"demand {row.get('demand_share', 0.0):.4f}  "
                f"delivered {row.get('delivered_share', 0.0):.4f}  "
                f"regret {row.get('regret', 0.0):.4f}"
                f"{flags}"
            )
        for p in pdoc.get("preemptions", []):
            print(
                f"  preempted {p.get('job_id') or p.get('job')}: "
                f"{p.get('reason') or p.get('mechanism')}"
            )
    for a in doc.get("alerts", []):
        print(
            f"ALERT pool {a['pool']} queue {a['queue']}: starved "
            f"{a['starved_rounds']} consecutive rounds"
        )


def cmd_policy(args):
    """Fairness-policy control plane (solver/policy.py): `show` the
    active policy per pool, `set`/clear a pool's policy at runtime
    (event-sourced, gated on a shadow scorecard), `ab` replay a
    recorded corpus under candidate policies side by side."""
    if args.policy_cmd == "ab":
        # Local replay, no server needed: the same harness as
        # tools/policy_ab.py, on the card unless --device names another.
        from ..device import resolve_device

        device = resolve_device(args.device or None)

        from ..trace.policy_ab import (
            DEFAULT_CANDIDATES,
            ab_compare,
            render_ab,
        )

        result = ab_compare(
            args.traces,
            args.policy or DEFAULT_CANDIDATES,
            solver=args.solver or "LOCAL",
            allow_foreign=args.allow_foreign,
            max_rounds=args.rounds or None,
            device=device,
        )
        _print(result) if args.json else print(render_ab(result))
        return
    client = connect(args.server, ca_cert=args.ca_cert or None)
    if args.policy_cmd == "set":
        if not args.policy and not args.clear:
            raise SystemExit("policy set wants a POLICY or --clear")
        scorecard = None
        if args.scorecard:
            with open(args.scorecard) as f:
                scorecard = json.load(f)
        out = client.policy_set(
            args.pool,
            None if args.clear else args.policy,
            force=args.force,
            scorecard=scorecard,
        )
        print(f"pool {out['pool']}: policy {out['policy']}")
        return
    doc = client.policy_show(pool=args.pool or None)
    if args.json:
        _print(doc)
        return
    print(f"default: {doc.get('default', 'drf')}")
    overrides = doc.get("overrides") or {}
    for pool in sorted(doc.get("pools") or {}):
        src = " (runtime override)" if pool in overrides else ""
        print(f"pool {pool}: {doc['pools'][pool]}{src}")


def _whatif_mutations(args) -> list[dict]:
    """Mutation dicts from the repeatable whatif flags (the same
    vocabulary every surface speaks, whatif/mutations.py)."""
    mutations = []
    for nid in args.cordon_node or []:
        mutations.append({"kind": "cordon_node", "name": nid})
    for nid in args.uncordon_node or []:
        mutations.append({"kind": "uncordon_node", "name": nid})
    for nid in args.remove_node or []:
        mutations.append({"kind": "remove_node", "name": nid})
    for name in args.cordon_executor or []:
        mutations.append({"kind": "cordon_executor", "name": name})
    for name in args.drain_executor or []:
        mutations.append({"kind": "drain_executor", "name": name})
    for spec in args.add_nodes or []:
        # COUNT[:CPU[:MEMORY[:GPU]]]
        parts = spec.split(":")
        try:
            m = {"kind": "add_nodes", "count": int(parts[0])}
        except ValueError:
            raise SystemExit(
                "--add-nodes wants COUNT[:CPU[:MEMORY[:GPU]]], "
                f"got {spec!r}"
            ) from None
        if len(parts) > 1:
            m["cpu"] = parts[1]
        if len(parts) > 2:
            m["memory"] = parts[2]
        if len(parts) > 3:
            m["gpu"] = parts[3]
        mutations.append(m)
    for spec in args.inject_gang or []:
        # QUEUE:CARDINALITY[:CPU[:MEMORY[:GPU]]]
        parts = spec.split(":")
        try:
            m = {
                "kind": "inject_gang",
                "queue": parts[0],
                "gang_cardinality": int(parts[1]),
            }
        except (IndexError, ValueError):
            raise SystemExit(
                "--inject-gang wants QUEUE:CARDINALITY[:CPU[:MEMORY"
                f"[:GPU]]], got {spec!r}"
            ) from None
        if len(parts) > 2:
            m["cpu"] = parts[2]
        if len(parts) > 3:
            m["memory"] = parts[3]
        if len(parts) > 4:
            m["gpu"] = parts[4]
        mutations.append(m)
    for spec in args.scale_queue or []:
        name, _, weight = spec.partition("=")
        try:
            mutations.append(
                {"kind": "scale_queue", "name": name,
                 "weight": float(weight)}
            )
        except ValueError:
            raise SystemExit(
                f"--scale-queue wants NAME=WEIGHT, got {spec!r}"
            ) from None
    if getattr(args, "policy", None):
        mutations.append({"kind": "policy", "policy": args.policy})
    return mutations


def cmd_whatif(args):
    """Shadow-solve hypothetical fleet edits against the live round
    fork: displaced jobs and their landings, injected-gang ETAs in
    rounds, per-queue/per-pool headroom (armada_tpu/whatif)."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    mutations = _whatif_mutations(args)
    out = client.what_if(
        mutations, pool=args.pool, solver=args.solver, rounds=args.rounds
    )
    if args.json:
        _print(out["plan"])
    else:
        print(out["rendered"])


def cmd_drain(args):
    """Drain an executor safely: `--dry-run` (default) predicts the
    outcome via a forked shadow solve; `--execute` runs the REAL staged
    drain (cordon -> voluntary completion -> gang-aware preempt-requeue
    at the deadline); `--status` polls an active drain."""
    client = connect(args.server, ca_cert=args.ca_cert or None)
    if args.status:
        status = client.execute_drain(args.executor, status_only=True)
        _print(status) if args.json else print(_render_drain_status(status))
        return
    if args.execute:
        status = client.execute_drain(
            args.executor, deadline_s=args.deadline_s
        )
        _print(status) if args.json else print(_render_drain_status(status))
        return
    out = client.plan_drain(
        args.executor,
        pool=args.pool,
        solver=args.solver,
        rounds=args.rounds,
        deadline_s=args.deadline_s,
    )
    if args.json:
        _print(out["plan"])
    else:
        print(out["rendered"])


def _render_drain_status(status: dict) -> str:
    if not isinstance(status, dict) or "executor" not in status:
        # status(None): every active drain keyed by executor.
        return json.dumps(status, indent=2, default=str)
    rounds = status.get("rounds_to_drain")
    return (
        f"drain {status['executor']}: {status.get('state')} "
        f"(round {status.get('rounds', 0)}, deadline "
        f"{status.get('deadline_s')}s)\n"
        f"  completed {len(status.get('completed', []))} · preempted "
        f"{len(status.get('preempted', []))} · blocked "
        f"{len(status.get('blocked', []))} · landed "
        f"{len(status.get('landings', {}))}"
        + (f"\n  drained in {rounds} rounds" if rounds is not None else "")
    )


def cmd_server(args):
    from ..core.config import SchedulingConfig
    from ..services.server import ControlPlane

    config = SchedulingConfig()
    if args.config:
        import yaml

        with open(args.config) as f:
            doc = yaml.safe_load(f) or {}
        config = SchedulingConfig.from_dict(doc.get("scheduling", doc))
    fakes = []
    for spec in args.fake_executor or []:
        # name:nodes:cpu e.g. clusterA:100:8
        parts = spec.split(":")
        fakes.append(
            {
                "name": parts[0],
                "nodes": int(parts[1]) if len(parts) > 1 else 10,
                "cpu": parts[2] if len(parts) > 2 else "8",
            }
        )
    tls = None
    if args.tls_cert or args.tls_key:
        if not (args.tls_cert and args.tls_key):
            raise SystemExit("--tls-cert and --tls-key must be given together")
        tls = (args.tls_cert, args.tls_key)
    plane = ControlPlane(
        config,
        backend=args.backend,
        mesh=args.mesh or None,
        device=args.device or None,
        grpc_port=args.port,
        metrics_port=args.metrics_port,
        lookout_port=args.lookout_port,
        fake_executors=fakes,
        cycle_period=args.cycle_period,
        data_dir=args.data_dir,
        tls=tls,
    ).start()
    extras = []
    if plane.metrics_port is not None:
        extras.append(f"metrics on :{plane.metrics_port}")
    if plane.lookout:
        extras.append(f"lookout UI on :{plane.lookout.port}")
    print(", ".join([f"serving on {plane.address}"] + extras))
    try:
        import signal

        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        plane.stop()


def build_parser():
    p = argparse.ArgumentParser(prog="armadactl-tpu")
    p.add_argument(
        "--server",
        default=os.environ.get("ARMADA_SERVER", "127.0.0.1:50051"),
        help="gRPC server address",
    )
    p.add_argument(
        "--ca-cert",
        default=os.environ.get("ARMADA_CA_CERT", ""),
        help="CA bundle: connect with TLS and verify the server against it",
    )
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("queue", help="queue CRUD")
    q.add_argument("action", choices=["create", "update", "delete", "get", "list"])
    q.add_argument("name", nargs="?", default="")
    q.add_argument("--priority-factor", type=float, default=None)
    q.add_argument("--cordon", action="store_true")
    q.add_argument("--uncordon", action="store_true")
    q.set_defaults(fn=cmd_queue)

    s = sub.add_parser("submit", help="submit jobs from a YAML file")
    s.add_argument("file")
    s.add_argument("--queue", default="")
    s.add_argument("--jobset", default="")
    s.set_defaults(fn=cmd_submit)

    c = sub.add_parser("cancel")
    c.add_argument("--queue", required=True)
    c.add_argument("--jobset", required=True)
    c.add_argument("--job-id")
    c.set_defaults(fn=cmd_cancel)

    r = sub.add_parser("reprioritize")
    r.add_argument("--queue", required=True)
    r.add_argument("--jobset", required=True)
    r.add_argument("--job-id", required=True)
    r.add_argument("--priority", type=int, required=True)
    r.set_defaults(fn=cmd_reprioritize)

    w = sub.add_parser("watch")
    w.add_argument("queue")
    w.add_argument("jobset")
    w.add_argument("--no-follow", action="store_true")
    w.set_defaults(fn=cmd_watch)

    j = sub.add_parser("jobs")
    j.add_argument("--queue")
    j.add_argument("--state")
    j.add_argument("--take", type=int, default=100)
    j.set_defaults(fn=cmd_jobs)

    lg = sub.add_parser("logs", help="stream job logs (binoculars)")
    lg.add_argument("job_id")
    lg.add_argument("--tail", type=int, default=100)
    lg.set_defaults(fn=cmd_logs)

    cd = sub.add_parser("node", help="cordon/uncordon a node")
    cd.add_argument("action", choices=["cordon", "uncordon"])
    cd.add_argument("node_id")
    cd.set_defaults(fn=cmd_cordon)

    ce = sub.add_parser("executor", help="cordon/uncordon a whole executor")
    ce.add_argument("action", choices=["cordon", "uncordon"])
    ce.add_argument("name")
    ce.set_defaults(fn=cmd_cordon_executor)

    rep = sub.add_parser("report")
    rep.add_argument("kind", choices=["scheduling", "queue", "job"])
    rep.add_argument("name", nargs="?", default="")
    rep.set_defaults(fn=cmd_report)

    jt = sub.add_parser(
        "job-trace",
        help="print a job's end-to-end journey (transitions + "
        "unschedulable-round history + trace id)",
    )
    jt.add_argument("job_id")
    jt.add_argument("--json", action="store_true",
                    help="raw journey record instead of the rendered text")
    jt.set_defaults(fn=cmd_job_trace)

    slo = sub.add_parser(
        "slo",
        help="show declared SLOs with compliance and burn rates",
    )
    slo.add_argument("--json", action="store_true")
    slo.set_defaults(fn=cmd_slo)

    doctor = sub.add_parser(
        "doctor",
        help="show the self-healing solve path's state (failover "
        "ladder breakers, recent round rejections + quarantine "
        "bundles, recent failovers)",
    )
    doctor.add_argument("--json", action="store_true")
    doctor.set_defaults(fn=cmd_doctor)

    fair = sub.add_parser(
        "fairness",
        help="show the per-pool fairness scorecard (entitlement vs "
        "delivered share, regret, Jain, preemption attribution, "
        "starvation alerts)",
    )
    fair.add_argument("--pool", default="")
    fair.add_argument("--json", action="store_true")
    fair.set_defaults(fn=cmd_fairness)

    pol = sub.add_parser(
        "policy",
        help="fairness-policy control plane: show/set the per-pool "
        "policy, or A/B candidate policies over a recorded corpus",
    )
    pol_sub = pol.add_subparsers(dest="policy_cmd", required=True)
    ps = pol_sub.add_parser("show", help="active policy per pool")
    ps.add_argument("--pool", default="")
    ps.add_argument("--json", action="store_true")
    pset = pol_sub.add_parser(
        "set",
        help="flip a pool's fairness policy at runtime (needs a shadow "
        "scorecard from `policy ab` unless --force)",
    )
    pset.add_argument("pool")
    pset.add_argument(
        "policy", nargs="?", default="",
        help="drf | proportional | priority | deadline",
    )
    pset.add_argument("--clear", action="store_true",
                      help="clear the runtime override (file config rules)")
    pset.add_argument("--force", action="store_true",
                      help="bypass the shadow-scorecard divergence gate")
    pset.add_argument(
        "--scorecard", default="",
        help="JSON scorecard file from `policy ab --json` to register "
        "as the flip's shadow evidence",
    )
    pab = pol_sub.add_parser(
        "ab",
        help="replay .atrace bundle(s) under candidate policies and "
        "print the scorecards side by side (local, no server)",
    )
    pab.add_argument("traces", nargs="+")
    pab.add_argument("--policy", action="append", metavar="POLICY")
    pab.add_argument("--solver", default="",
                     help="LOCAL | hotwindow[:W] | 2x4 (default LOCAL)")
    pab.add_argument("--rounds", type=int, default=0)
    pab.add_argument("--allow-foreign", action="store_true")
    pab.add_argument("--json", action="store_true")
    pab.add_argument("--device", default="",
                     help="torch device of the replays (default: the CUDA card)")
    pol.set_defaults(fn=cmd_policy)

    wi = sub.add_parser(
        "whatif",
        help="shadow-solve hypothetical fleet edits (cordon/drain/"
        "inject-gang/...) against a fork of the live round",
    )
    wi.add_argument("--pool", default="")
    wi.add_argument(
        "--solver", default="",
        help="shadow solver spec: oracle | LOCAL | hotwindow[:W] | 2x4",
    )
    wi.add_argument("--rounds", type=int, default=0,
                    help="rollout horizon in scheduling rounds")
    wi.add_argument("--json", action="store_true")
    wi.add_argument("--cordon-node", action="append", metavar="NODE")
    wi.add_argument("--uncordon-node", action="append", metavar="NODE")
    wi.add_argument("--remove-node", action="append", metavar="NODE")
    wi.add_argument("--cordon-executor", action="append", metavar="NAME")
    wi.add_argument("--drain-executor", action="append", metavar="NAME")
    wi.add_argument("--add-nodes", action="append",
                    metavar="COUNT[:CPU[:MEM[:GPU]]]")
    wi.add_argument("--inject-gang", action="append",
                    metavar="QUEUE:CARD[:CPU[:MEM[:GPU]]]")
    wi.add_argument("--scale-queue", action="append", metavar="NAME=WEIGHT")
    wi.add_argument(
        "--policy", default="",
        help="re-solve the fork under this fairness policy (drf | "
        "proportional | priority | deadline); fairness_delta names "
        "the payers",
    )
    wi.set_defaults(fn=cmd_whatif)

    dr = sub.add_parser(
        "drain",
        help="drain an executor: --dry-run predicts (forked shadow "
        "solve), --execute runs the staged drain for real",
    )
    dr.add_argument("executor")
    group = dr.add_mutually_exclusive_group()
    group.add_argument("--dry-run", action="store_true",
                       help="predict the outcome (default)")
    group.add_argument("--execute", action="store_true",
                       help="start (or poll) the real drain")
    group.add_argument("--status", action="store_true",
                       help="poll the active drain's status")
    dr.add_argument("--deadline-s", type=float, default=None,
                    help="voluntary-completion window before preemption")
    dr.add_argument("--pool", default="")
    dr.add_argument("--solver", default="")
    dr.add_argument("--rounds", type=int, default=0)
    dr.add_argument("--json", action="store_true")
    dr.set_defaults(fn=cmd_drain)

    srv = sub.add_parser("server", help="run a local control plane")
    srv.add_argument("--port", type=int, default=50051)
    srv.add_argument("--metrics-port", type=int, default=None)
    srv.add_argument("--lookout-port", type=int, default=None)
    srv.add_argument(
        "--data-dir", help="durable event-log directory (in-memory if unset)"
    )
    srv.add_argument("--config")
    srv.add_argument("--backend", default="kernel", choices=["oracle", "kernel"])
    srv.add_argument(
        "--mesh",
        default="",
        help="sharded-solve mesh for --backend kernel: chip count (\"8\") "
        "or hosts x chips (\"2x4\", two-level ICI+DCN hierarchy)",
    )
    srv.add_argument(
        "--device",
        default="",
        help="torch device of the kernel backend (default: the CUDA card)",
    )
    srv.add_argument("--cycle-period", type=float, default=1.0)
    srv.add_argument("--tls-cert", default="", help="TLS certificate (PEM)")
    srv.add_argument("--tls-key", default="", help="TLS private key (PEM)")
    srv.add_argument(
        "--fake-executor",
        action="append",
        help="name:nodes:cpu, repeatable",
    )
    srv.set_defaults(fn=cmd_server)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except BrokenPipeError:
        # stdout consumer (e.g. head) closed the pipe: normal for CLIs.
        try:
            sys.stdout.close()
        except Exception:
            pass
        sys.exit(0)
    except Exception as e:
        # An RpcError comes from a loaded grpc; where grpc was never
        # imported (no grpcio, an in-process client) the error is raised
        # as it is.
        grpc = sys.modules.get("grpc")
        if grpc is not None and isinstance(e, grpc.RpcError):
            print(f"error: {e.details()}", file=sys.stderr)
            sys.exit(1)
        raise


if __name__ == "__main__":
    main()
