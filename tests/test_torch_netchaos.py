"""The port's network chaos proxy (armada_tpu_torch/services/netchaos.py),
lease fencing and anti-entropy sync (services/grpc_api.py), the executor
agent's lease TTL and resync (services/executor_agent.py) and its node
classification (services/node_info.py), against the JAX package's, on
the CPU.

Every case of tests/test_netchaos.py runs side by side on both packages
(`torch_control_plane.run_side_by_side`): each case's own assertions
hold on both, and the leases after every cycle of every scheduler
service are equal (not in the real-socket case, whose control plane
cycles on the wall clock in a thread of its own). The partition soak
calls each package's own chaos soak tool.

`test_proxy_forwards_cleanly` is the one case run on the port alone,
with a bounded wait: the proxy counts a chunk in `bytes_forwarded` once
it is sent (`ChaosProxy._pump`), so the echo's reply can reach the
client before the reply's pump thread counts it, and the reference
case, which reads the counter right after its round trip, fails now and
then on the JAX package itself (ROADMAP, "Not port faults"). The port
keeps that semantics; its copy waits up to 2 s for the count.

A direct twin drives both packages' proxies through the same script of
fault windows on a virtual clock and holds what each client call saw,
and the proxies' counters once they settle, equal.
"""

import importlib
import socket
import time

import pytest
import torch_cpu  # noqa: F401

from torch_control_plane import case_marks, plain, port_copy, run_side_by_side

# The port's soak solves on the kernel backend on the card unless asked
# otherwise; its copy of the soak case names the CPU.
PORT_SUBS = (
    (r"from tools\.chaos_soak import", "from armada_tpu_torch.tools.chaos_soak import"),
    (r'(\brun_plan\(seed, "oracle", 24)', r'\1, device="cpu"'),
)
PORT_ONLY = "test_proxy_forwards_cleanly"
WALL_CLOCK = ("test_real_socket_partition_fencing_and_heal",)


def _cases():
    ref = importlib.import_module("test_netchaos")
    return [t for t in sorted(vars(ref)) if t.startswith("test_") and t != PORT_ONLY]


CASES = _cases()


def test_every_netchaos_case_is_collected():
    assert len(CASES) == 18 and PORT_ONLY not in CASES
    assert set(WALL_CLOCK) <= set(CASES)


@pytest.mark.parametrize(
    "test", [pytest.param(t, marks=case_marks("test_netchaos", t), id=t) for t in CASES])
def test_netchaos_case_matches_reference(test, monkeypatch, tmp_path):
    run_side_by_side("test_netchaos", test, monkeypatch, tmp_path, port_subs=PORT_SUBS,
                     cycles=test not in WALL_CLOCK)


def test_proxy_forwards_cleanly():
    """The reference case on the port's proxy, its counter read once both
    pumps have counted (at most 2 s): both directions, exactly."""
    m = port_copy("test_netchaos")
    proxy, close = m.start_proxy(m.FaultPlan([]), m.VirtualClock())
    try:
        sock = m.connect(proxy)
        assert m.roundtrip(sock, b"hello") == b"hello"
        sock.close()
        deadline = time.monotonic() + 2.0
        while proxy.bytes_forwarded < 10 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert proxy.bytes_forwarded == 10  # both directions
    finally:
        proxy.stop()
        close()


WAIT_S = 10.0  # the most any step of the script waits for the proxy's threads


def _settle(proxy, want_forwarded, want_blackholed):
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and (
            proxy.bytes_forwarded < want_forwarded or proxy.bytes_blackholed < want_blackholed):
        time.sleep(0.005)


def _script(name):
    """The same fault script through package `name`'s proxy in front of an
    echo server: a clean round trip, a black hole, a delay, a partition
    (live connection cut, new connects refused) and its heal, an RST.
    Returns what each client call saw and the proxy's counters."""
    m = port_copy("test_netchaos", port=name == "armada_tpu_torch")
    chaos = importlib.import_module(f"{name}.services.chaos")
    plan = chaos.FaultPlan([
        chaos.FaultSpec("network_blackhole", "e0", 10.0, 10.0),
        chaos.FaultSpec("network_delay", "e0", 20.0, 10.0, param=0.05),
        chaos.FaultSpec("network_partition", "e0", 30.0, 10.0),
        chaos.FaultSpec("network_rst", "e0", 50.0, 10.0),
    ])
    clock = chaos.VirtualClock(0.0)
    proxy, close = m.start_proxy(plan, clock)
    seen = []

    def call(sock, payload):
        try:
            seen.append(("ok", m.roundtrip(sock, payload)))
        except socket.timeout:
            seen.append(("timeout",))
        except OSError:
            seen.append(("closed",))

    try:
        sock = m.connect(proxy)
        call(sock, b"clean")
        clock.now = 15.0
        sock.settimeout(0.3)
        call(sock, b"hole")
        _settle(proxy, 10, 4)
        sock.close()
        clock.now = 25.0
        sock = m.connect(proxy)
        t0 = time.monotonic()
        call(sock, b"slow")
        seen.append(("delayed", time.monotonic() - t0 >= 0.05))
        clock.now = 35.0
        deadline = time.monotonic() + WAIT_S
        while proxy.connections_severed < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        call(sock, b"cut")
        sock.close()
        refused = False
        deadline = time.monotonic() + WAIT_S
        while not refused and time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", proxy._listen_port), 0.5).close()
                time.sleep(0.02)
            except OSError:
                refused = True
        seen.append(("refused", refused))
        clock.now = 45.0
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            try:
                sock = m.connect(proxy)
                break
            except OSError:
                time.sleep(0.02)
        call(sock, b"healed")
        clock.now = 55.0
        sock.settimeout(1.0)
        call(sock, b"reset")
        sock.close()
        _settle(proxy, 10 + 8 + 12, 4)
        counters = dict(forwarded=proxy.bytes_forwarded, blackholed=proxy.bytes_blackholed,
                        rebind_errors=proxy.rebind_errors)
    finally:
        proxy.stop()
        close()
    return seen, counters


def test_proxy_fault_script_matches_reference():
    ref = _script("armada_tpu")
    port = _script("armada_tpu_torch")
    assert plain(port) == plain(ref)
    seen, counters = port
    assert seen[0] == ("ok", b"clean") and seen[1] == ("timeout",)
    assert ("refused", True) in seen and ("ok", b"healed") in seen
    assert counters["blackholed"] == 4
