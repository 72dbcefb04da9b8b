"""Lookout: HTTP JSON API + single-page web UI over the job database.

The reference serves a React/MUI UI (internal/lookoutui) against a REST API
(internal/lookout) backed by its own Postgres materialization. Here the
same surface is a JSON-over-HTTP gateway onto the QueryApi/reports (the
grpc-gateway pattern, pkg/api/*.pb.gw.go) plus an embedded single-page UI
(lookout_ui.py): job table with server-side filter/sort/group, job-details
drawer with per-run error/debug/termination drilldown, queue fair-share
view, scheduling report.

  GET /api/jobs?filters=<json>&order=&direction=&skip=&take=
      (filters: [{"field","value","match","isAnnotation"}]; the simple
       queue=/state=/jobset= params still work)
  GET /api/groups?by=F[&byAnnotation=1]&aggregates=<json>&filters=<json>
  GET /api/queues
  GET /api/fairshare             (per-pool queue shares, latest round)
  GET /api/fairness              (fairness observatory: share ledger,
                                  preemption attribution, starvation
                                  alerts — observe/fairness.py)
  GET /api/report
  GET /api/errors
  GET /api/logs/<job_id>?tail=N   (binoculars log fetch, when wired)
  GET /api/runs/<run_id>/error|debug|termination
  GET /api/slo                   (SLO compliance + burn rates)
  GET /api/doctor                (self-healing solve path: ladder
                                  breakers, round rejections +
                                  quarantine bundles, failovers)
  GET /api/jobtrace/<job_id>     (job journey: transitions + reasons)
  GET /api/details/<job_id>      (row + runs incl. debug)
  GET /api/job/<id>              (spec + runs)
  GET /                          (the UI)
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.parse
from dataclasses import asdict

from .lookout_ui import UI_HTML
from .queryapi import JobFilter, Order


def _parse_filters(params: dict) -> list[JobFilter]:
    """Filters from the JSON `filters` param plus the legacy simple
    params (queue=, state=, jobset=)."""
    filters = []
    raw = params.get("filters")
    if raw:
        for f in json.loads(raw):
            filters.append(
                JobFilter(
                    field=f["field"],
                    value=f.get("value"),
                    match=f.get("match", "exact"),
                    is_annotation=bool(
                        f.get("isAnnotation", f.get("is_annotation", False))
                    ),
                )
            )
    for key in ("queue", "state", "jobset"):
        if params.get(key):
            filters.append(JobFilter(key, params[key]))
    return filters


class LookoutHttpServer:
    def __init__(self, query, scheduler, submit, port: int = 0,
                 bind: str = "127.0.0.1", tls: tuple | None = None,
                 auth=None, authorizer=None, binoculars=None,
                 frontdoor=None):
        self.query = query
        self.scheduler = scheduler
        self.submit = submit
        # Optional log access (services/binoculars.py): the reference UI
        # fetches container logs through the binoculars service.
        self.binoculars = binoculars
        # Optional front door (armada_tpu_torch/frontdoor): /api/frontdoor
        # serves shard lag + per-tenant admitted/shed — the overload
        # runbook's "find the hot tenant" view.
        self.frontdoor = frontdoor
        # Optional auth chain for the mutation endpoints (reads stay
        # open, like the reference's lookout deployment posture).
        self.auth = auth
        self.authorizer = authorizer
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _json(self, obj, code=200):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                params = dict(urllib.parse.parse_qsl(parsed.query))
                try:
                    self._route(parsed, params)
                except Exception as e:  # surface handler errors as 500s
                    self._json({"error": str(e)}, 500)

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                try:
                    # CSRF defense: cross-origin <form enctype=text/plain>
                    # submissions cannot set custom headers or this
                    # content type; the UI's fetch() sets both.
                    if (
                        self.headers.get("Content-Type", "")
                        .split(";")[0]
                        .strip()
                        != "application/json"
                        or self.headers.get("X-Requested-With")
                        != "armada-lookout"
                    ):
                        self._json(
                            {"error": "missing CSRF headers"}, 403
                        )
                        return
                    length = int(self.headers.get("Content-Length") or 0)
                    body = (
                        json.loads(self.rfile.read(length)) if length else {}
                    )
                    self._mutate(parsed.path, body)
                except Exception as e:
                    self._json({"error": str(e)}, 500)

            def _mutate(self, path, body):
                """UI mutations (the reference UI's cancel/reprioritize
                actions, lookoutui submitApi usage)."""
                if outer.submit is None:
                    self._json({"error": "mutations unavailable"}, 503)
                    return
                if outer.auth is not None:
                    # Same chain as the gRPC API: Authorization header ->
                    # principal -> queue-scoped cancel/reprioritize verbs.
                    from .auth import (
                        CANCEL_ANY_JOBS,
                        REPRIORITIZE_ANY_JOBS,
                        AuthError,
                        PermissionDenied,
                    )

                    try:
                        principal = outer.auth.authenticate(
                            {
                                "authorization": self.headers.get(
                                    "Authorization", ""
                                )
                            }
                        )
                        if outer.authorizer is not None:
                            queue = outer.submit.get_queue(
                                body.get("queue", "")
                            )
                            verb, perm = (
                                ("cancel", CANCEL_ANY_JOBS)
                                if path == "/api/cancel"
                                else ("reprioritize", REPRIORITIZE_ANY_JOBS)
                            )
                            outer.authorizer.authorize_queue(
                                principal, verb, queue, perm
                            )
                    except AuthError as e:
                        self._json({"error": str(e)}, 401)
                        return
                    except PermissionDenied as e:
                        self._json({"error": str(e)}, 403)
                        return
                if path == "/api/cancel":
                    queue, jobset = body.get("queue"), body.get("jobset")
                    ids = body.get("job_ids") or []
                    reason = body.get("reason", "cancelled from lookout")
                    if not queue or not jobset:
                        self._json({"error": "queue and jobset required"}, 400)
                        return
                    if ids:
                        for jid in ids:
                            outer.submit.cancel_job(queue, jobset, jid, reason)
                    else:
                        outer.submit.cancel_jobset(queue, jobset, reason)
                    self._json({"cancelled": len(ids) or "jobset"})
                elif path == "/api/reprioritize":
                    for jid in body.get("job_ids") or []:
                        outer.submit.reprioritise_job(
                            body["queue"], body["jobset"], jid,
                            int(body["priority"]),
                        )
                    self._json({"reprioritized": len(body.get("job_ids") or [])})
                else:
                    self._json({"error": "not found"}, 404)

            def _route(self, parsed, params):
                if parsed.path == "/" or parsed.path == "/index.html":
                    body = UI_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif parsed.path == "/api/jobs":
                    rows, total = outer.query.get_jobs(
                        _parse_filters(params),
                        Order(
                            params.get("order", "submitted"),
                            params.get("direction", "desc"),
                        ),
                        int(params.get("skip", 0)),
                        int(params.get("take", 100)),
                    )
                    self._json({"jobs": [asdict(r) for r in rows], "total": total})
                elif parsed.path == "/api/groups":
                    aggregates = []
                    if params.get("aggregates"):
                        aggregates = json.loads(params["aggregates"])
                    self._json(
                        {
                            "groups": outer.query.group_jobs(
                                params.get("by", "state"),
                                _parse_filters(params),
                                aggregates=aggregates,
                                group_by_annotation=params.get("byAnnotation")
                                in ("1", "true"),
                                order_by=params.get("orderBy", "count"),
                                direction=params.get("direction", "desc"),
                                skip=int(params.get("skip", 0)),
                                take=int(params.get("take", 0)),
                            )
                        }
                    )
                elif parsed.path == "/api/queues":
                    self._json(
                        {
                            "queues": [
                                {
                                    "name": q.spec.name,
                                    "priority_factor": q.spec.priority_factor,
                                    "cordoned": q.cordoned,
                                }
                                for q in outer.submit.queues.values()
                            ]
                        }
                    )
                elif parsed.path == "/api/fairshare":
                    # Queue oversight: the latest round's per-queue shares
                    # (lookoutui's fair-share/oversight columns; reports
                    # QueueReport per pool).
                    pools = {}
                    for pool, rep in (
                        outer.scheduler.reports.latest_reports().items()
                    ):
                        pools[pool] = [
                            {
                                "queue": qr.queue,
                                "fair_share": qr.fair_share,
                                "adjusted_fair_share": qr.adjusted_fair_share,
                                "actual_share": qr.actual_share,
                                "scheduled_jobs": qr.scheduled_jobs,
                                "preempted_jobs": qr.preempted_jobs,
                                "top_reasons": dict(qr.top_reasons),
                            }
                            for qr in rep.queues.values()
                        ]
                    self._json({"pools": pools})
                elif parsed.path == "/api/fairness":
                    # Fairness observatory (observe/fairness.py): the
                    # latest per-pool share ledger (entitlement vs
                    # delivered, regret, Jain), the round's preemption
                    # attribution map and active starvation alerts —
                    # the "Diagnosing an unfair pool" runbook's first
                    # stop (docs/operations.md).
                    tracker = getattr(outer.scheduler, "fairness", None)
                    if tracker is None:
                        self._json(
                            {"error": "fairness observatory not enabled"},
                            503,
                        )
                        return
                    self._json(tracker.snapshot())
                elif parsed.path == "/api/report":
                    self._json(
                        {"report": outer.scheduler.reports.scheduling_report()}
                    )
                elif parsed.path == "/api/prices":
                    # Market mode: last round's indicative gang prices
                    # (MarketDrivenIndicativePrices surfaced by
                    # cycle_metrics.go:681; spot price per pool).
                    self._json(
                        {
                            pool: {
                                "spot_price": rep.spot_price,
                                "gangs": {
                                    name: asdict(pr)
                                    for name, pr in rep.indicative_prices.items()
                                },
                            }
                            for pool, rep in
                            outer.scheduler.reports.latest_reports().items()
                        }
                    )
                elif parsed.path == "/api/errors":
                    self._json(
                        {"errors": outer.query.get_job_errors(
                            _parse_filters(params)
                        )}
                    )
                elif parsed.path.startswith("/api/runs/"):
                    # /api/runs/<run_id>/<error|debug|termination>
                    parts = parsed.path.split("/")
                    if len(parts) != 5:
                        self._json({"error": "bad run path"}, 404)
                        return
                    run_id, kind = parts[3], parts[4]
                    fn = {
                        "error": outer.query.get_job_run_error,
                        "debug": outer.query.get_job_run_debug_message,
                        "termination":
                            outer.query.get_job_run_termination_reason,
                    }.get(kind)
                    if fn is None:
                        self._json({"error": f"unknown drilldown {kind}"}, 404)
                    else:
                        self._json({"run_id": run_id, "message": fn(run_id)})
                elif parsed.path.startswith("/api/logs/"):
                    if outer.binoculars is None:
                        self._json({"error": "logs unavailable"}, 503)
                        return
                    job_id = parsed.path.rsplit("/", 1)[1]
                    try:
                        tail = int(params.get("tail", 100))
                        # 0 is rejected too: lines[-0:] would mean "all".
                        if tail <= 0:
                            raise ValueError
                    except ValueError:
                        self._json({"error": "tail must be a positive "
                                    "integer"}, 400)
                        return
                    try:
                        lines = outer.binoculars.get_logs(job_id, tail)
                    except KeyError as e:
                        self._json({"error": e.args[0] if e.args else str(e)},
                                   404)
                        return
                    self._json({"job_id": job_id, "lines": lines})
                elif parsed.path == "/api/whatif":
                    # What-if planner (armada_tpu_torch/whatif). Without
                    # params: recent plans + active drain statuses.
                    # With ?queue=Q&gang=N[&cpu=&memory=&gpu=][&solver=]
                    # [&rounds=]: run a gang-injection what-if on the
                    # bounded planner worker (503 on backpressure).
                    svc = getattr(outer.scheduler, "whatif", None)
                    if svc is None:
                        self._json({"error": "what-if planner not "
                                    "enabled"}, 503)
                        return
                    if params.get("queue") and params.get("gang"):
                        from ..whatif import mutations_from_dicts
                        from ..whatif.planner import WhatIfBusyError

                        mutation = {
                            "kind": "inject_gang",
                            "queue": params["queue"],
                            "gang_cardinality": int(params["gang"]),
                        }
                        for key in ("cpu", "memory", "gpu"):
                            if params.get(key):
                                mutation[key] = params[key]
                        try:
                            plan = svc.plan(
                                mutations_from_dicts([mutation]),
                                pool=params.get("pool") or None,
                                solver=params.get("solver") or None,
                                rounds=int(params["rounds"])
                                if params.get("rounds")
                                else None,
                            )
                        except WhatIfBusyError as e:
                            self._json({"error": str(e)}, 503)
                            return
                        self._json(
                            {"plan": plan.to_dict(),
                             "rendered": plan.render()}
                        )
                        return
                    self._json(
                        {
                            "plans": list(svc.recent),
                            "drains": svc.drain_status() or {},
                        }
                    )
                elif parsed.path == "/api/slo":
                    # SLO status (services/slo.py): declared objectives,
                    # compliance and multi-window burn rates — the view
                    # the "Reading the round cost ledger" runbook pairs
                    # with /metrics to decide whether churn is hurting
                    # users yet.
                    tracker = getattr(outer.scheduler, "slo", None)
                    if tracker is None:
                        self._json({"error": "SLO tracking not enabled"},
                                   503)
                        return
                    self._json(tracker.snapshot())
                elif parsed.path == "/api/doctor":
                    # Self-healing solve path (solver/validate.py +
                    # solver/failover.py): ladder breaker states, recent
                    # admission-firewall rejections with quarantine
                    # bundle paths, recent failovers — the "Responding
                    # to a quarantined round" runbook's first stop
                    # (docs/operations.md).
                    report = getattr(
                        outer.scheduler, "doctor_report", None
                    )
                    if report is None:
                        self._json(
                            {"error": "doctor report not available"}, 503
                        )
                        return
                    self._json(report())
                elif parsed.path == "/api/frontdoor":
                    # Front-door overload view (armada_tpu_torch/frontdoor):
                    # per-shard ingest lag / delivery counters and the
                    # per-tenant admitted/shed table sorted hot-first —
                    # the "Surviving an overload" runbook reads this to
                    # identify the tenant to re-quota.
                    if outer.frontdoor is None:
                        self._json({"error": "front door not enabled"},
                                   503)
                        return
                    self._json(outer.frontdoor.snapshot())
                elif parsed.path.startswith("/api/jobtrace/"):
                    # Job journey (services/job_timeline.py): transitions
                    # + aggregated unschedulable-round history + trace id.
                    # Local view, like every lookout read (a follower's
                    # ledger lacks round reasons — the leader runs the
                    # rounds; the gRPC JobTrace method leader-proxies).
                    job_id = parsed.path.rsplit("/", 1)[1]
                    trace = outer.query.job_trace(job_id)
                    if trace is None:
                        self._json({"error": "no journey recorded"}, 404)
                    else:
                        self._json(trace)
                elif parsed.path.startswith("/api/details/"):
                    job_id = parsed.path.rsplit("/", 1)[1]
                    details = outer.query.job_details(job_id)
                    if details is None:
                        self._json({"error": "not found"}, 404)
                    else:
                        self._json(details)
                elif parsed.path.startswith("/api/job/"):
                    job_id = parsed.path.rsplit("/", 1)[1]
                    spec = outer.query.get_job_spec(job_id)
                    if spec is None:
                        self._json({"error": "not found"}, 404)
                    else:
                        self._json(
                            {
                                "spec": asdict(spec),
                                "runs": [
                                    asdict(r)
                                    for r in outer.query.get_job_runs(job_id)
                                ],
                            }
                        )
                else:
                    self._json({"error": "not found"}, 404)

            def log_message(self, *a):
                pass

        # Loopback by default, matching the gRPC API posture; pass
        # bind="0.0.0.0" explicitly to expose on the network.
        self.server = http.server.ThreadingHTTPServer((bind, port), Handler)
        if tls is not None:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls[0], tls[1])
            self.server.socket = ctx.wrap_socket(
                self.server.socket, server_side=True
            )
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.server.shutdown()
