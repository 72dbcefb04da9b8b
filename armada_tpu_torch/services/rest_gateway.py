"""REST/JSON gateway for the full API surface.

The reference exposes every gRPC service over REST through grpc-gateway
(pkg/api/*.pb.gw.go, wired in internal/server/server.go);
non-gRPC clients (curl, the C++ client library in native/client) use it.
This gateway fronts the same service objects the gRPC ApiServer uses:

  POST /api/v1/queue                   create queue
  PUT  /api/v1/queue/<name>            update queue
  GET  /api/v1/queue/<name>            get queue
  GET  /api/v1/queues                  list queues
  DELETE /api/v1/queue/<name>          delete queue
  POST /api/v1/job/submit              {queue, jobset, jobs: [...]}
  POST /api/v1/job/cancel              {queue, jobset, job_ids|cancel_jobset}
  POST /api/v1/job/reprioritize        {queue, jobset, job_ids, priority}
  GET  /api/v1/jobset/<q>/<js>/events?from=N[&watch=false]
  GET  /api/v1/jobs?queue=&state=...   query rows

Auth: the same chain as the gRPC server — `authorization` header with
Basic or Bearer credentials, mapped through the shared Authorizer.

This is the port's copy of the JAX package's services/rest_gateway.py:
`http.server` over the same service objects, needing `google.protobuf`
only on the binary submit route (Content-Type application/x-protobuf).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .auth import AuthError, PermissionDenied
from .grpc_api import job_spec_from_dict
from .queryapi import JobFilter, Order


class RestGateway:
    def __init__(
        self,
        submit,
        scheduler,
        query,
        log,
        port: int = 0,
        auth=None,
        authorizer=None,
        api=None,
        tls: tuple | None = None,
    ):
        self.submit = submit
        self.scheduler = scheduler
        self.query = query
        self.log = log
        self.auth = auth
        self.authorizer = authorizer
        # Reuse the gRPC ApiServer's authorization mapping when given.
        self._api = api
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, obj, code=200):
                body = json.dumps(obj, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b""
                return json.loads(raw.decode()) if raw else {}

            def _gate(self, method: str, req: dict) -> bool:
                if outer.auth is None:
                    return True
                md = {"authorization": self.headers.get("Authorization", "")}
                try:
                    principal = outer.auth.authenticate(md)
                    if outer._api is not None:
                        outer._api._authorize(method, principal, req)
                    return True
                except AuthError as e:
                    self._json({"error": str(e)}, 401)
                except PermissionDenied as e:
                    self._json({"error": str(e)}, 403)
                return False

            def _route(self, verb: str):
                parsed = urllib.parse.urlparse(self.path)
                params = dict(urllib.parse.parse_qsl(parsed.query))
                parts = [p for p in parsed.path.split("/") if p]
                try:
                    outer._dispatch(self, verb, parts, params)
                except (KeyError,) as e:
                    self._json({"error": str(e)}, 404)
                except ValueError as e:
                    self._json({"error": str(e)}, 400)
                except Exception as e:
                    self._json({"error": repr(e)}, 500)

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                self._route("POST")

            def do_PUT(self):
                self._route("PUT")

            def do_DELETE(self):
                self._route("DELETE")

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
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

    # ---- routing ----

    def _dispatch(self, h, verb: str, parts: list[str], params: dict):
        from ..core.types import QueueSpec

        if parts[:2] != ["api", "v1"]:
            return h._json({"error": "not found"}, 404)
        rest = parts[2:]

        if rest == ["queues"] and verb == "GET":
            if not h._gate("ListQueues", {}):
                return
            return h._json(
                {
                    "queues": [
                        {
                            "name": q.spec.name,
                            "priority_factor": q.spec.priority_factor,
                            "cordoned": q.cordoned,
                        }
                        for q in self.submit.queues.values()
                    ]
                }
            )
        if rest and rest[0] == "queue":
            if verb == "POST" and len(rest) == 1:
                body = h._body()
                if not h._gate("CreateQueue", body):
                    return
                self.submit.create_queue(
                    QueueSpec(
                        body["name"], float(body.get("priority_factor", 1.0))
                    ),
                    cordoned=bool(body.get("cordoned", False)),
                )
                return h._json({})
            if len(rest) == 2:
                name = rest[1]
                if verb == "GET":
                    if not h._gate("GetQueue", {"queue": name}):
                        return
                    q = self.submit.get_queue(name)
                    if q is None:
                        return h._json({"error": "not found"}, 404)
                    return h._json(
                        {
                            "name": q.spec.name,
                            "priority_factor": q.spec.priority_factor,
                            "cordoned": q.cordoned,
                        }
                    )
                if verb == "PUT":
                    body = h._body()
                    if not h._gate("UpdateQueue", body):
                        return
                    pf = body.get("priority_factor")
                    self.submit.update_queue(
                        name,
                        priority_factor=float(pf) if pf is not None else None,
                        cordoned=body.get("cordoned"),
                    )
                    return h._json({})
                if verb == "DELETE":
                    if not h._gate("DeleteQueue", {"queue": name}):
                        return
                    self.submit.delete_queue(name)
                    return h._json({})
        if rest == ["job", "submit"] and verb == "POST":
            # Binary protobuf on the same route (proto/armada.proto
            # JobSubmitRequest) — the transcoding the reference's
            # grpc-gateway does for pkg/api/submit.proto. Codegen clients
            # (e.g. the C++ client) POST application/x-protobuf; the
            # json_format mapping lands in the identical body dict.
            ctype = h.headers.get("Content-Type", "")
            if ctype.startswith("application/x-protobuf"):
                from google.protobuf import json_format

                from ..proto import armada_pb2 as pb

                length = int(h.headers.get("Content-Length", 0))
                raw = h.rfile.read(length) if length else b""
                body = json_format.MessageToDict(
                    pb.JobSubmitRequest.FromString(raw),
                    preserving_proto_field_name=True,
                    always_print_fields_with_no_presence=True,
                )
            else:
                body = h._body()
            if not h._gate("SubmitJobs", body):
                return
            jobs = [
                job_spec_from_dict(j).with_(
                    queue=body["queue"], jobset=body["jobset"]
                )
                for j in body.get("jobs", [])
            ]
            ids = self.submit.submit(body["queue"], body["jobset"], jobs)
            if "application/x-protobuf" in h.headers.get("Accept", ""):
                from ..proto import armada_pb2 as pb

                payload = pb.JobSubmitResponse(
                    job_ids=ids
                ).SerializeToString()
                h.send_response(200)
                h.send_header("Content-Type", "application/x-protobuf")
                h.send_header("Content-Length", str(len(payload)))
                h.end_headers()
                h.wfile.write(payload)
                return
            return h._json({"job_ids": ids})
        if rest == ["job", "cancel"] and verb == "POST":
            body = h._body()
            if not h._gate("CancelJobs", body):
                return
            for job_id in body.get("job_ids", []):
                self.submit.cancel_job(
                    body["queue"], body["jobset"], job_id, body.get("reason", "")
                )
            if body.get("cancel_jobset"):
                self.submit.cancel_jobset(
                    body["queue"], body["jobset"], body.get("reason", "")
                )
            return h._json({})
        if rest == ["job", "reprioritize"] and verb == "POST":
            body = h._body()
            if not h._gate("ReprioritizeJobs", body):
                return
            for job_id in body.get("job_ids", []):
                self.submit.reprioritise_job(
                    body["queue"], body["jobset"], job_id, int(body["priority"])
                )
            return h._json({})
        if rest[:1] == ["jobset"] and len(rest) == 4 and rest[3] == "events":
            queue, jobset = rest[1], rest[2]
            if not h._gate("WatchJobSet", {"queue": queue}):
                return
            events = []
            start = int(params.get("from", 0))
            for entry in self.log.read(start, int(params.get("limit", 1000))):
                seq = entry.sequence
                if seq.queue != queue or seq.jobset != jobset:
                    continue
                for event in seq.events:
                    events.append(
                        {
                            "offset": entry.offset,
                            "type": type(event).__name__,
                            "job_id": getattr(event, "job_id", ""),
                            "created": getattr(event, "created", 0.0),
                        }
                    )
            end = self.log.end_offset
            return h._json({"events": events, "next": end})
        if rest == ["jobs"] and verb == "GET":
            if not h._gate("GetJobs", params):
                return
            filters = []
            for field_name in ("queue", "jobset", "state", "job_id"):
                if params.get(field_name):
                    filters.append(JobFilter(field_name, params[field_name]))
            rows, total = self.query.get_jobs(
                filters,
                Order(
                    params.get("order", "submitted"),
                    params.get("direction", "desc"),
                ),
                int(params.get("skip", 0)),
                int(params.get("take", 100)),
            )
            return h._json({"jobs": [asdict(r) for r in rows], "total": total})
        return h._json({"error": "not found"}, 404)
