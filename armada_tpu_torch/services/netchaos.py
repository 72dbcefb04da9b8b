"""TCP-level network chaos proxy: sever the wire itself, on a schedule.

The fault layer of services/chaos.py injects failures INSIDE processes
— crashes, hangs, slow leases, torn log writes. This module injects them
BETWEEN processes: a ChaosProxy sits on the TCP path an executor agent
(or a follower proxying report RPCs to the leader) uses to reach the API
server, and, driven by the same seeded `FaultPlan`, can:

  network_partition  sever the link: live connections are torn down and
                     the listener goes DOWN for the window (new connects
                     get kernel-clean ECONNREFUSED) — the classic
                     symmetric partition
  network_blackhole  swallow bytes without closing: the far side never
                     answers, so callers hang until their own deadline
  network_delay      add `param` seconds of latency per forwarded chunk
  network_throttle   cap the forwarding byte rate (param scales
                     THROTTLE_BYTES_PER_SEC)
  network_rst        close with SO_LINGER(0) so the peer sees ECONNRESET
                     rather than a clean FIN

The proxy is deliberately dumb about protocols: it forwards opaque
bytes, so gRPC/HTTP2 framing, TLS, and the JSON and protobuf executor
wires all flow through unmodified. Fault windows are evaluated against
the proxy's clock (seconds since start by default; injectable for
tests), so a plan is a reproducible schedule even though the kernel's
TCP timing is not — determinism lives in WHEN the wire breaks, and the
control plane's job is to converge to the same jobdb state regardless of
how the break interleaves with traffic (the fencing + anti-entropy
protocol asserted by tests/test_netchaos.py; the bit-identical soak runs
on the simulator's virtual-clock partitions instead of real sockets).

This is the port's copy of the JAX package's services/netchaos.py, the
same proxy with the same counters: a chunk counts in `bytes_forwarded`
once it has been sent, so a reply can reach its client a moment before
the pump that carried it has counted it.
"""

from __future__ import annotations

import socket
import threading
import time as _time

from .chaos import FaultPlan

# network_throttle byte rate at param=1.0; the generated param in
# (0.1, 0.9) scales it down, so even a heavily throttled lease exchange
# (a few KiB) completes within a cycle rather than timing out.
THROTTLE_BYTES_PER_SEC = 256 * 1024

_CHUNK = 65536


class ChaosProxy:
    """One proxied TCP link (listen -> upstream) under a FaultPlan.

    `name` is the plan target this link matches (conventionally the
    executor name for agent->server links, "leader" for follower->leader
    report proxying); "*" specs match every link.
    """

    def __init__(
        self,
        name: str,
        upstream_host: str,
        upstream_port: int,
        plan: FaultPlan | None = None,
        clock=None,
        listen_port: int = 0,
    ):
        self.name = name
        self.upstream = (upstream_host, upstream_port)
        self.plan = plan
        self._t0 = _time.monotonic()
        # Default clock: seconds since proxy start, the same zero the
        # plan's windows are authored against in live runs.
        self.clock = clock if clock is not None else (
            lambda: _time.monotonic() - self._t0
        )
        self._listen_port = listen_port
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set[tuple] = set()  # (client_sock, upstream_sock)
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        # Observability counters (read by tests and operators; the
        # scheduler-side fencing metrics live in services/metrics.py).
        self.connections_total = 0
        self.connections_severed = 0
        self.bytes_forwarded = 0
        self.bytes_blackholed = 0
        self.rebind_errors = 0

    # ---- plan queries ----

    def _active(self, kind: str):
        if self.plan is None:
            return None
        return self.plan.active(kind, self.name, self.clock())

    # ---- lifecycle ----

    def start(self) -> int:
        """Bind and serve; returns the listen port."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("127.0.0.1", self._listen_port))
        ls.listen(64)
        self._listener = ls
        self._listen_port = ls.getsockname()[1]
        accept = threading.Thread(target=self._accept_loop, daemon=True)
        accept.start()
        reaper = threading.Thread(target=self._reaper_loop, daemon=True)
        reaper.start()
        self._threads += [accept, reaper]
        return self._listen_port

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self._listen_port}"

    def stop(self):
        self._stopping.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._kill_all(rst=False, count=False)
        for t in self._threads:
            t.join(timeout=2.0)

    # ---- connection handling ----

    def _severed_window(self):
        return (
            self._active("network_partition")
            or self._active("network_rst")
        )

    def _accept_loop(self):
        # The listener polls with a short timeout so sever windows are
        # noticed between connections.
        self._listener.settimeout(0.1)
        while not self._stopping.is_set():
            if self._severed_window() is not None:
                # Severed wire: take the LISTENER down for the window, so
                # new connects are refused cleanly by the kernel
                # (ECONNREFUSED). Accepting and instantly closing instead
                # would RST clients mid-connect — real gRPC clients
                # (grpc 1.68 posix engine) have been observed to wedge
                # their reconnect path for minutes after that, which
                # models a client bug, not a partition.
                self._listener.close()
                while (
                    not self._stopping.is_set()
                    and self._severed_window() is not None
                ):
                    self._stopping.wait(0.05)
                if self._stopping.is_set():
                    return
                # Rebind can transiently fail (TIME_WAIT edge, or another
                # process squatting the released ephemeral port): retry
                # rather than letting the exception kill the accept
                # thread and turn a healed partition into a forever-dead
                # proxy. Persistent failure is surfaced via rebind_errors.
                while not self._stopping.is_set():
                    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    try:
                        ls.bind(("127.0.0.1", self._listen_port))
                        ls.listen(64)
                    except OSError:
                        ls.close()
                        self.rebind_errors += 1
                        self._stopping.wait(0.2)
                        continue
                    ls.settimeout(0.1)
                    self._listener = ls
                    break
                if self._stopping.is_set():
                    return
            try:
                client, _ = self._listener.accept()
            except TimeoutError:
                continue
            except OSError:
                if self._stopping.is_set():
                    return  # listener closed by stop()
                continue
            client.settimeout(None)
            self.connections_total += 1
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
                # The connect timeout must NOT linger as an I/O timeout:
                # a blocking recv that times out after 5 idle seconds
                # would sever every quiet connection (a parked gRPC
                # channel between lease exchanges) without any fault
                # window being active.
                up.settimeout(None)
            except OSError:
                self._close(client, rst=False)
                continue
            pair = (client, up)
            with self._lock:
                self._conns.add(pair)
                # Drop joined pump threads so a long-lived proxy doesn't
                # accumulate dead handles.
                self._threads = [t for t in self._threads if t.is_alive()]
            for src, dst in ((client, up), (up, client)):
                t = threading.Thread(
                    target=self._pump, args=(pair, src, dst), daemon=True
                )
                t.start()
                self._threads.append(t)

    def _pump(self, pair, src: socket.socket, dst: socket.socket):
        try:
            while not self._stopping.is_set():
                try:
                    data = src.recv(_CHUNK)
                except OSError:
                    break
                if not data:
                    break
                spec = self._active("network_partition")
                if spec is not None:
                    self._kill_pair(pair, rst=False)
                    break
                if self._active("network_rst") is not None:
                    self._kill_pair(pair, rst=True)
                    break
                if self._active("network_blackhole") is not None:
                    # Swallow silently; the connection stays open so the
                    # caller blocks on its own deadline, like a routing
                    # black hole (no FIN, no RST, no bytes).
                    self.bytes_blackholed += len(data)
                    continue
                delay = self._active("network_delay")
                if delay is not None and delay.param > 0:
                    _time.sleep(min(delay.param, 5.0))
                throttle = self._active("network_throttle")
                if throttle is not None:
                    rate = max(throttle.param, 0.01) * THROTTLE_BYTES_PER_SEC
                    _time.sleep(min(len(data) / rate, 5.0))
                try:
                    dst.sendall(data)
                except OSError:
                    break
                self.bytes_forwarded += len(data)
        finally:
            # Clean teardown (EOF, peer close): not a severed connection.
            self._kill_pair(pair, rst=False, count=False)

    def _reaper_loop(self):
        """Kill LIVE connections the moment a sever/RST window opens — a
        partition must cut idle and in-flight streams (a parked gRPC
        HTTP/2 connection, a mid-lease exchange), not just future bytes."""
        while not self._stopping.is_set():
            if self._active("network_partition") is not None:
                self._kill_all(rst=False)
            elif self._active("network_rst") is not None:
                self._kill_all(rst=True)
            self._stopping.wait(0.05)

    def _kill_all(self, rst: bool, count: bool = True):
        with self._lock:
            pairs = list(self._conns)
        for pair in pairs:
            self._kill_pair(pair, rst=rst, count=count)

    def _kill_pair(self, pair, rst: bool, count: bool = True):
        with self._lock:
            if pair not in self._conns:
                # Already torn down by the other pump / the reaper; close
                # again anyway (idempotent) but don't double-count.
                first_teardown = False
            else:
                self._conns.discard(pair)
                first_teardown = True
        if first_teardown and count:
            self.connections_severed += 1
        for sock in pair:
            self._close(sock, rst=rst)

    @staticmethod
    def _close(sock: socket.socket, rst: bool):
        try:
            if rst:
                # SO_LINGER with zero timeout: close() sends RST, the
                # peer sees ECONNRESET instead of a clean shutdown.
                import struct

                sock.setsockopt(
                    socket.SOL_SOCKET,
                    socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            sock.close()
        except OSError:
            pass
