"""Asyncio client: the async variant of ApiClient.

The reference ships a synchronous and an asyncio gRPC client
(client/python/armada_client/{client.py,asyncio_client.py}) with the same
method surface. Same here: AsyncApiClient mirrors
services.grpc_api.ApiClient over grpc.aio — unary calls are awaitable,
watch_jobset is an async generator — so event-driven tooling (dashboards,
operators) can multiplex many watches on one event loop instead of one
thread per stream.

    client = AsyncApiClient("127.0.0.1:50051")
    await client.create_queue("team")
    ids = await client.submit_jobs("team", "run-1", jobs)
    async for event in client.watch_jobset("team", "run-1"):
        ...
    await client.close()

This is the port's copy of the JAX package's clients/aio.py. It is a
`grpc.aio` client, so it runs where `grpc` is installed (the CPU tests),
not on the card's machine; `grpc` is imported when a client opens its
channel.
"""

from __future__ import annotations

from ..services.grpc_api import SERVICE, _decode, _encode


class AsyncApiClient:
    """grpc.aio twin of services.grpc_api.ApiClient; same auth metadata
    convention (Bearer token or basic pair)."""

    def __init__(self, target: str, token: str | None = None, basic=None):
        import grpc.aio

        self.channel = grpc.aio.insecure_channel(target)
        self._metadata: list = []
        if token:
            self._metadata = [("authorization", f"Bearer {token}")]
        elif basic:
            import base64

            user, password = basic
            cred = base64.b64encode(f"{user}:{password}".encode()).decode()
            self._metadata = [("authorization", f"Basic {cred}")]

    async def close(self):
        await self.channel.close()

    async def _call(self, method: str, request: dict):
        fn = self.channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=bytes,
            response_deserializer=bytes,
        )
        return _decode(await fn(_encode(request), metadata=self._metadata or None))

    # ---- the ApiClient surface, awaitable ----

    async def submit_jobs(self, queue, jobset, jobs: list[dict]):
        return (
            await self._call(
                "SubmitJobs", {"queue": queue, "jobset": jobset, "jobs": jobs}
            )
        )["job_ids"]

    async def cancel_jobs(
        self, queue, jobset, job_ids=(), cancel_jobset=False, reason=""
    ):
        await self._call(
            "CancelJobs",
            {
                "queue": queue,
                "jobset": jobset,
                "job_ids": list(job_ids),
                "cancel_jobset": cancel_jobset,
                "reason": reason,
            },
        )

    async def reprioritize_jobs(self, queue, jobset, job_ids, priority):
        await self._call(
            "ReprioritizeJobs",
            {
                "queue": queue,
                "jobset": jobset,
                "job_ids": list(job_ids),
                "priority": priority,
            },
        )

    async def create_queue(self, name, priority_factor=1.0, cordoned=False):
        await self._call(
            "CreateQueue",
            {"name": name, "priority_factor": priority_factor, "cordoned": cordoned},
        )

    async def update_queue(self, name, priority_factor=None, cordoned=None):
        await self._call(
            "UpdateQueue",
            {"name": name, "priority_factor": priority_factor, "cordoned": cordoned},
        )

    async def delete_queue(self, name):
        await self._call("DeleteQueue", {"name": name})

    async def get_queue(self, name):
        return await self._call("GetQueue", {"name": name})

    async def list_queues(self):
        return (await self._call("ListQueues", {}))["queues"]

    async def get_jobs(
        self,
        filters=(),
        order_field="submitted",
        order_direction="asc",
        skip=0,
        take=100,
    ):
        return await self._call(
            "GetJobs",
            {
                "filters": list(filters),
                "order_field": order_field,
                "order_direction": order_direction,
                "skip": skip,
                "take": take,
            },
        )

    async def group_jobs(self, group_by, filters=(), aggregates=()):
        return (
            await self._call(
                "GroupJobs",
                {
                    "group_by": group_by,
                    "filters": list(filters),
                    "aggregates": list(aggregates),
                },
            )
        )["groups"]

    async def scheduling_report(self):
        return (await self._call("SchedulingReport", {}))["report"]

    async def queue_report(self, queue):
        return (await self._call("QueueReport", {"queue": queue}))["report"]

    async def job_report(self, job_id):
        return (await self._call("JobReport", {"job_id": job_id}))["report"]

    async def get_job_logs(self, job_id, tail_lines=100):
        return (
            await self._call(
                "GetJobLogs", {"job_id": job_id, "tail_lines": tail_lines}
            )
        )["lines"]

    async def watch_jobset(self, queue, jobset, from_offset=0, watch=True):
        """Async stream of jobset events (GetJobSetEvents)."""
        fn = self.channel.unary_stream(
            f"/{SERVICE}/WatchJobSet",
            request_serializer=bytes,
            response_deserializer=bytes,
        )
        call = fn(
            _encode(
                {
                    "queue": queue,
                    "jobset": jobset,
                    "from_offset": from_offset,
                    "watch": watch,
                }
            ),
            metadata=self._metadata or None,
        )
        async for raw in call:
            yield _decode(raw)
